"""The epsilon rule of a dense product [n, fi] -> [n, fo] for K clones of b
instances: z is the forward's own output (or one product at b, where
``forward`` is True), the transposed product runs per clone."""


def work(b, K, n, fi, fo, forward=False):
    ops = 2.0 * n * fi * fo * (K * b + (b if forward else 0))
    nbytes = 4.0 * (b * n * fi + fi * fo)
    return ops, nbytes
