"""Images whose logits reached the host inside the window, over the
window's seconds (host clock)."""

LAYER = None
MOVES = None


def read(ctx):
    w = ctx.window
    served = sum(1 for r in w.requests
                 if not r.failed and r.done is not None and r.done <= w.end)
    return served / w.seconds
