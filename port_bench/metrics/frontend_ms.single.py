"""Host milliseconds a request spends in the program's text front end
(cleaners and encoding, ``TextProcessing.encode_text``), by the harness's
clock around that call, over every request of the window."""


def read(ctx):
    recs = ctx.extras["records"]
    return 1e3 * sum(r["encode_s"] for r in recs) / len(recs) if recs else None
