"""Convert a JAX training checkpoint into a PyTorch port checkpoint.

Restores an orbax checkpoint with the JAX CLIs' own loaders
(``fastpitch/inference.py::load_fastpitch``, ``hifigan/inference.py::load_generator``),
converts the parameters with ``neuraltexttospeech_torch.convert`` and writes
the port checkpoint (``model.pt`` + ``model_config.json``) that
``python -m neuraltexttospeech_torch.cli.fastpitch_infer`` and
``...cli.hifigan_infer`` read. It then runs both models on a small input on
the CPU and prints the largest difference.

Usage:
  python tools/jax_to_torch_checkpoint.py fastpitch \
      --checkpoint out/fastpitch/checkpoints -o out/torch/fastpitch
  python tools/jax_to_torch_checkpoint.py hifigan \
      --checkpoint out/hifigan/checkpoints -o out/torch/hifigan [--config v1]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def export_fastpitch(config, params, out_dir, frontend=None):
    """Write a port FastPitch checkpoint from a JAX config and params tree;
    returns the largest |port - JAX| mel difference on a 32-token input."""
    import jax.numpy as jnp
    import torch

    from neuraltexttospeech_torch.convert import fastpitch_from_flax
    from neuraltexttospeech_torch.models import fastpitch as port_fp
    from neuraltexttospeech_torch.models.registry import (
        config_from_dict, load_checkpoint, save_checkpoint,
    )
    from neuraltexttospeech_tpu.models.fastpitch import FastPitch
    from neuraltexttospeech_tpu.models.registry import config_to_dict

    port_cfg = config_from_dict(port_fp.FastPitchConfig, config_to_dict(config))
    save_checkpoint(out_dir, "FastPitch", port_cfg,
                    fastpitch_from_flax(_numpy_tree(params)), frontend=frontend)
    text = np.random.default_rng(0).integers(1, config.n_symbols, (1, 32)).astype(np.int32)
    ref = FastPitch(config).apply(params, jnp.asarray(text), jnp.asarray([32]),
                                  max_mel_len=256, method=FastPitch.infer)[0]
    model, _ = load_checkpoint(out_dir, "FastPitch", torch.device("cpu"))
    with torch.no_grad():
        ours = model.infer(torch.as_tensor(text), None, max_mel_len=256)[0]
    return float(np.abs(ours.numpy() - np.asarray(ref, np.float32)).max())


def export_hifigan(config, params, out_dir):
    """Write a port HiFi-GAN generator checkpoint from a JAX config and
    params tree; returns the largest |port - JAX| audio difference on a
    32-frame input."""
    import jax.numpy as jnp
    import torch

    from neuraltexttospeech_torch.convert import generator_from_flax
    from neuraltexttospeech_torch.models import hifigan as port_hg
    from neuraltexttospeech_torch.models.registry import (
        config_from_dict, load_checkpoint, save_checkpoint,
    )
    from neuraltexttospeech_tpu.models.hifigan import Generator
    from neuraltexttospeech_tpu.models.registry import config_to_dict

    port_cfg = config_from_dict(port_hg.HiFiGANConfig, config_to_dict(config))
    save_checkpoint(out_dir, "HiFiGAN", port_cfg, generator_from_flax(_numpy_tree(params)))
    mel = np.random.default_rng(0).standard_normal((1, 32, config.num_mels)).astype(np.float32)
    ref = Generator(config).apply(params, jnp.asarray(mel))
    model, _ = load_checkpoint(out_dir, "HiFiGAN", torch.device("cpu"))
    with torch.no_grad():
        ours = model(torch.as_tensor(mel))
    return float(np.abs(ours.numpy() - np.asarray(ref, np.float32)).max())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", choices=("fastpitch", "hifigan"))
    p.add_argument("--checkpoint", required=True, help="orbax checkpoint dir")
    p.add_argument("-o", "--output", required=True, help="port checkpoint dir to write")
    p.add_argument("--config", default=None,
                   help="hifigan only: v1/v2/v3 or a config json, as hifigan/inference.py")
    args = p.parse_args(argv)

    from neuraltexttospeech_tpu.models.registry import (
        find_model_config, load_frontend_config, load_model_config,
    )

    if args.model == "fastpitch":
        from fastpitch.inference import load_fastpitch
        from neuraltexttospeech_tpu.models.fastpitch import FastPitchConfig

        config = (load_model_config(args.checkpoint)[1]
                  if find_model_config(args.checkpoint) else FastPitchConfig())
        _, params = load_fastpitch(args.checkpoint, config)
        diff = export_fastpitch(config, params, args.output,
                                frontend=load_frontend_config(args.checkpoint))
    else:
        from hifigan.inference import load_generator

        gen, params = load_generator(args.checkpoint, args.config)
        diff = export_hifigan(gen.config, params, args.output)
    print(f"wrote {args.output}; max |port - JAX| on a small CPU input: {diff:.3e}")


if __name__ == "__main__":
    main()
