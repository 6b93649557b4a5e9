"""Device policy, masking and batched-serving helpers."""
