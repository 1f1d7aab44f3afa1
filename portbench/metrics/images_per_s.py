"""images_per_s: images of every call completed in the window over the
time from the first call's start to the last call's synced end."""


def read(rec):
    if not rec.calls:
        return None
    return sum(n for _s, _e, n in rec.calls) / (rec.calls[-1][1] - rec.calls[0][0])
