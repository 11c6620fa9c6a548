"""A dense layer's forward at batch b."""


def work(b, fi, fo):
    return 2.0 * b * fi * fo, 4.0 * (b * (fi + fo) + fi * fo + fo)
