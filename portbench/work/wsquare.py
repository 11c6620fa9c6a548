"""The w-square rule of a first convolution for K clones of b instances:
its denominator f(1; w^2, b^2) does not depend on the input, so only the
transposed convolution runs per clone. Bytes: the weights, the clones'
relevance maps at the input written once."""


def work(b, K, H, W, ci, co, kh=3, kw=3):
    ops = 2.0 * K * b * H * W * ci * co * kh * kw
    nbytes = 4.0 * (co * ci * kh * kw + co + K * b * H * W * ci)
    return ops, nbytes
