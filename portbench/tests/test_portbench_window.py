"""The serve entry's window keeps what the comparison reads in blocks made
before the window: the results it keeps in set-up's slots, the front-end's
log-mels in one device block. Which requests the seed keeps then changes
nothing the window allocates or holds (held where the seed drew them, the
program's own arrays moved the host heap's layout, and with it the speed of
the later requests, by the seed)."""

import time

from tests import tiny
from pb import model, program, spans


def test_kept_results_and_log_mels_live_in_blocks_made_before_the_window():
    c = tiny.cell("gtzan3s.serve_b256", batch=2)
    ctx = tiny.run.Ctx(c["cfg"], c["traffic"], 2 ** 31 + 3, "cpu")
    params, U = model.draw(ctx.cfg, ctx.seed, "cpu")
    ctx.svc = program.service(ctx.cfg, params, U, "cpu")
    entry = tiny.run.load("entries", "serve")
    capture = spans.Capture()
    try:
        entry.setup(ctx)
        slots = [id(s) for s in ctx.slots]
        keep = tiny.run.sampled(ctx.seed, ctx.traffic)
        capture.start(keep)
        t0 = time.perf_counter()
        win = entry.window(ctx, 1.0, lambda i: i in keep)
    finally:
        capture.patches.remove()
    assert time.perf_counter() - t0 < 60
    last = max(win["kept"])
    held = [i for i in win["kept"] if i in keep and i != last]
    assert held and all(id(win["kept"][i][0]) in slots for i in held)
    assert capture.block is not None and len(capture.kept) == len([i for i in keep
                                                                   if i < win["attempted"]])
    block = capture.block.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == block for t in capture.kept.values())
