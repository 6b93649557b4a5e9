from port_bench.faults import patched


def altered_audio():
    """The vocoder's first output sample of every batch is changed."""
    from neuraltexttospeech_torch.cli import hifigan_infer

    def make(orig):
        def vocode(generator, mel, dtype=None):
            out = orig(generator, mel, dtype).clone()
            out[:, 0] += 0.5
            return out
        return vocode

    return patched(hifigan_infer, "vocode", make)
