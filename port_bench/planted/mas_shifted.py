from port_bench.faults import patched


def mas_shifted():
    """MAS's path with one frame moved across one token boundary in the
    batch's first utterance: the first token with two frames or more gives
    its first frame to the token before it (token 0 its last to token 1)."""
    from neuraltexttospeech_torch.models import fastpitch

    def make(orig):
        def maximum_path(log_attn, in_lens, out_lens, *args, **kwargs):
            path = orig(log_attn, in_lens, out_lens, *args, **kwargs).clone()
            dur = path[0].sum(0).long().tolist()
            j = next(j for j, d in enumerate(dur) if d >= 2)
            if j:
                f = sum(dur[:j])
                path[0, f, j], path[0, f, j - 1] = 0.0, 1.0
            else:
                path[0, dur[0] - 1, 0], path[0, dur[0] - 1, 1] = 0.0, 1.0
            return path
        return maximum_path

    return patched(fastpitch, "maximum_path", make)
