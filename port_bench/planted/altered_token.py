from port_bench.faults import patched


def altered_token():
    """The front end returns one id changed in every utterance."""
    from neuraltexttospeech_torch.text.processing import TextProcessing

    def make(orig):
        def encode_text(self, text, return_all=False):
            ids = list(orig(self, text))
            ids[len(ids) // 2] = ids[len(ids) // 2] % 60 + 1
            return ids
        return encode_text

    return patched(TextProcessing, "encode_text", make)
