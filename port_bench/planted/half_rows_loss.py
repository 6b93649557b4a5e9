from port_bench.faults import patched


def half_rows_loss():
    """The FastPitch loss averages over the first half of its batch's rows
    alone; the forward, its dropout and MAS still run on every row, so what
    the run records fits its batch."""
    from neuraltexttospeech_torch.cli import fastpitch_train

    def make(orig):
        def loss(out, mel, in_lens, out_lens, *args, **kwargs):
            half = mel.shape[0] // 2
            out = type(out)(*(None if v is None else v[:half] for v in out))
            return orig(out, mel[:half], in_lens[:half], out_lens[:half], *args, **kwargs)
        return loss

    return patched(fastpitch_train, "fastpitch_loss", make)
