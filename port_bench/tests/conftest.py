import torch

# several test processes share the machine: a few threads each
torch.set_num_threads(2)
