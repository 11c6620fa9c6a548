"""The gamma rule of a stride-1 'same' convolution for K relevance clones
of b instances. The incoming relevance passes a relu gate, so it is zero
wherever the true output is not positive and only the positive term is
needed: its denominator z = conv(x+, w + g*w+) + conv(x-, w + g*w-), shared
by the clones and run once at b, and its transposed convolution per clone.
With non-negative input (``nonneg``) x- is zero and each is one
convolution; with inputs of both signs, two. Bytes: the layer input and
the weights; the clones' relevance between layers may stay on chip, so it
is not counted."""


def work(b, K, H, W, ci, co, kh=3, kw=3, nonneg=True):
    conv = 2.0 * H * W * ci * co * kh * kw
    terms = 1 if nonneg else 2
    ops = terms * b * conv + terms * K * b * conv
    nbytes = 4.0 * (b * H * W * ci + co * ci * kh * kw + co)
    return ops, nbytes
