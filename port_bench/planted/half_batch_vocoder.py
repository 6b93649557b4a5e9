from port_bench.faults import patched


def half_batch_vocoder():
    """The vocoder leaves out the second half of each batch (zeros there)."""
    from neuraltexttospeech_torch.cli import hifigan_infer

    def make(orig):
        def vocode(generator, mel, dtype=None):
            out = orig(generator, mel, dtype).clone()
            out[(out.shape[0] + 1) // 2:] = 0.0
            return out
        return vocode

    return patched(hifigan_infer, "vocode", make)
