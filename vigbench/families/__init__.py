"""Model families: each module here sets up one kind of system under
test for the harness (``families/<family>.py``, named by the
configuration file's ``family``), with its plain reference and the
controls that its comparison must refuse. A configuration in any
precision enters the benchmark with new files only: its configuration,
its limits, and a family module when no family here serves it.

A family module provides (``CONTRACT``):

- ``setup(cfg, seed, device) -> (weights, pool, pool_host)``: the
  weights and the pool of inputs, made from the seed; ``pool_host`` has
  one entry per input along its first axis (``pool_host.shape[0]``).
- ``System(cfg, weights, pool_host, device)``, the program under test
  (``SYSTEM``): ``submit(uid, item)`` queues a request for pool entry
  ``item``; ``step()`` runs one tick and returns the requests it
  finished, ``[(uid, answer, lane)]`` with ``answer`` None for one that
  failed; ``queued()`` counts the requests submitted and not yet
  returned; ``last_bucket()`` is the width of the last tick's program.
- ``warm(system, mix, pool)``: serves every shape the mix will use, in
  set-up. ``build_seconds()``: the seconds the program spent building
  its kernels in this process.
- ``reference(cfg, weights, pool, precision="<its own>")``: the plain
  reference, imported from nothing of the program, worked out from the
  weights and pool that ``setup`` makes (its own draw of them).
- ``compare(window, ref, limits) -> {name: {"value", "limit"}}``: what
  decides ``correct``; ``held(window, ref, limits) -> {name: value}``:
  the same numbers with what they are read from.
- ``controls(cfg, weights, pool, window, ref) -> {name: window}``: the
  window's requests answered by each control; ``CONTROL_BREAKS``, ``{name:
  limit}``: the held limit that each control's window must exceed.

Three rules hold for every family:

- A control computes in the configuration's own arithmetic one step
  lower: TF32 under fp32, fp8 e4m3 products under bf16.
- ``reference`` returns answers per pool item, or an object that
  ``compare`` calls with the program's answers, so that a generating
  model is teacher-forced on the tokens it emitted itself.
- ``lane`` is ``(width, row)``: the width of the program that computed
  the answer and its row there (a bucket's lane, or a slot), so that
  ``control.break_upper_lanes`` applies to every family.
"""

CONTRACT = ("setup", "System", "warm", "build_seconds", "reference", "compare",
            "held", "controls", "CONTROL_BREAKS")
SYSTEM = ("submit", "step", "queued", "last_bucket")
