"""Operations and bytes the algorithm needs, one module a layer kind, from
shapes only. A product counts 2 operations (multiply and add). Counts are
of the algorithm, whatever implements it: a scheme that runs a product
several times (3xTF32's three passes) or a kernel that re-reads its input
does not count more. Each input byte is read once and each output byte
written once."""
