"""A stride-1 'same' convolution's forward at batch b."""


def work(b, H, W, ci, co, kh=3, kw=3):
    ops = 2.0 * b * H * W * ci * co * kh * kw
    nbytes = 4.0 * (b * H * W * (ci + co) + co * ci * kh * kw + co)
    return ops, nbytes
