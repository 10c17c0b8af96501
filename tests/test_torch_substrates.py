"""The port's substrates against the JAX package: the synthetic data
pipelines (batch for batch, bit for bit), the checkpoint format (each
package restores the other's checkpoint bit for bit, a bf16 leaf and an
``OptState`` included) and the straggler monitor. Mirrors of
``tests/test_substrates.py``'s data, checkpoint and straggler tests."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig,
    image_pipeline,
    lm_pipeline,
    synth_image_batch,
    synth_lm_batch,
)
from repro_torch.distributed.straggler import (  # noqa: E402
    StragglerConfig,
    StragglerMonitor,
    aggregate_host_times,
)
from repro_torch.models import module  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("hosts,host_id", [(1, 0), (2, 0), (2, 1)])
def test_batches_equal_jax_bit_for_bit(hosts, host_id):
    kw = dict(seq_len=24, global_batch=4, vocab_size=97, seed=7,
              num_hosts=hosts, host_id=host_id)
    dc, jdc = DataConfig(**kw), jpipe.DataConfig(**kw)
    for step in (0, 1, 5, 30):
        got, want = synth_lm_batch(dc, step), jpipe.synth_lm_batch(jdc, step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        got = synth_image_batch(dc, step, image_size=16, num_classes=10)
        want = jpipe.synth_image_batch(jdc, step, image_size=16, num_classes=10)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_pipelines_equal_jax_from_a_start_step():
    dc = DataConfig(seq_len=8, global_batch=2, vocab_size=11, seed=3)
    jdc = jpipe.DataConfig(seq_len=8, global_batch=2, vocab_size=11, seed=3)
    pairs = [(lm_pipeline(dc, 4), jpipe.lm_pipeline(jdc, 4)),
             (image_pipeline(dc, 8, 5, 4), jpipe.image_pipeline(jdc, 8, 5, 4))]
    try:
        for mine, theirs in pairs:
            for _ in range(3):
                (s, b), (js, jb) = next(mine), next(theirs)
                assert s == js
                for k in jb:
                    np.testing.assert_array_equal(b[k], jb[k])
    finally:
        for pipe in (p for pair in pairs for p in pair):
            pipe.close()


def test_pipeline_deterministic_across_restart():
    dc = DataConfig(seq_len=32, global_batch=4, vocab_size=97, seed=7)
    b1 = synth_lm_batch(dc, 5)
    b2 = synth_lm_batch(dc, 5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = synth_lm_batch(dc, 6)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_pipeline_host_sharding_disjoint():
    a = synth_lm_batch(DataConfig(32, 8, 97, seed=1, num_hosts=2, host_id=0), 0)
    b = synth_lm_batch(DataConfig(32, 8, 97, seed=1, num_hosts=2, host_id=1), 0)
    assert a["tokens"].shape == (4, 32)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_prefetch_iterator_order():
    dc = DataConfig(seq_len=8, global_batch=2, vocab_size=11, seed=3)
    pipe = lm_pipeline(dc, start_step=10)
    try:
        steps = [next(pipe)[0] for _ in range(4)]
        assert steps == [10, 11, 12, 13]
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


def test_labels_are_next_tokens():
    dc = DataConfig(seq_len=16, global_batch=2, vocab_size=31, seed=0)
    b = synth_lm_batch(dc, 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# checkpoint


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16) * 1.5},
            "d": (torch.zeros(2), torch.full((3,), 7.0)),
            "e": {}}


def _equal(x, y):
    return x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 3, tree)
    restored, step = ckpt.restore(tmp_path, tree)
    assert step == 3 and restored["e"] == {} and isinstance(restored["d"], tuple)
    for path, x in module.leaves({"a": tree["a"], "b": tree["b"]}).items():
        assert _equal(module.leaves(restored)[path], x)
    assert all(_equal(x, y) for x, y in zip(restored["d"], tree["d"]))
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert manifest["leaves"]["b/c"] == {"shape": [4], "dtype": "bfloat16"}
    assert sorted(manifest["leaves"]) == ["a", "b/c", "d/0", "d/1"]


def test_checkpoint_latest_and_gc(tmp_path):
    tree = {"w": torch.ones(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, tree, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    kept = sorted(d.name for d in tmp_path.iterdir() if d.name.startswith("step"))
    assert kept == ["step_00000004", "step_00000005"]


def test_checkpoint_ignores_uncommitted(tmp_path):
    tree = {"w": torch.ones(2)}
    ckpt.save(tmp_path, 1, tree)
    (tmp_path / "step_00000002").mkdir()  # a crashed half-write at step 2
    assert ckpt.latest_step(tmp_path) == 1
    assert ckpt.latest_step(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "missing", tree)


def test_async_checkpointer(tmp_path):
    tree = {"w": torch.arange(4.0)}
    saver = ckpt.AsyncCheckpointer(tmp_path)
    saver.save(7, tree)
    tree["w"].add_(1.0)  # the snapshot was taken at save()
    saver.wait()
    restored, step = ckpt.restore(tmp_path, tree)
    assert step == 7
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(4.0))


def test_async_checkpointer_raises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    saver = ckpt.AsyncCheckpointer(blocker / "ckpt")
    saver.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        saver.wait()


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 1, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="shape mismatch for w"):
        ckpt.restore(tmp_path, {"w": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf v"):
        ckpt.restore(tmp_path, {"v": torch.ones(2)})


def _state_pair():
    """The same parameters and a stepped ``OptState`` in both packages."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "n": {"s": rng.standard_normal((5,)).astype(np.float32)}}
    grads = {"w": rng.standard_normal((3, 4)).astype(np.float32),
             "n": {"s": rng.standard_normal((5,)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    jp2, jstate, _ = jopt.adamw_update(jax.tree.map(jnp.asarray, grads),
                                       jopt.init_opt_state(jp), jopt.OptConfig(),
                                       params_dtype=jnp.bfloat16)
    tp = module.map_tree(lambda _, t: torch.from_numpy(t), params)
    tp2, state, _ = opt.adamw_update(
        module.map_tree(lambda _, t: torch.from_numpy(t), grads),
        opt.init_opt_state(tp), opt.OptConfig(), params_dtype=torch.bfloat16)
    return {"params": jp2, "opt": jstate}, {"params": tp2, "opt": state}


def _assert_jax_equals_torch(jtree, ttree):
    jflat, tflat = jckpt._flatten(jtree), ckpt._flatten(ttree)
    assert jflat.keys() == tflat.keys()
    for key, t in tflat.items():
        j = np.asarray(jflat[key])
        assert str(j.dtype) == ckpt._NAMES[t.dtype], key
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(j.view(np.int16), t.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(j, t.numpy())


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jtree, ttree = _state_pair()
    jckpt.save(tmp_path, 4, jtree)
    template = {"params": module.map_tree(lambda _, t: torch.zeros_like(t),
                                          ttree["params"]),
                "opt": opt.init_opt_state(ttree["params"])}
    restored, step = ckpt.restore(tmp_path, template)
    assert step == 4 and isinstance(restored["opt"], opt.OptState)
    assert restored["params"]["w"].dtype == torch.bfloat16
    _assert_jax_equals_torch(jtree, restored)


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    jtree, ttree = _state_pair()
    ckpt.save(tmp_path, 9, ttree)
    restored, step = jckpt.restore(tmp_path, jtree)
    assert step == 9 and isinstance(restored["opt"], jopt.OptState)
    _assert_jax_equals_torch(restored, ttree)


# ---------------------------------------------------------------------------
# straggler monitor


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(StragglerConfig(window=20, mad_k=4, min_samples=5))
    for _ in range(10):
        mon.record(0.1)
    assert not mon.is_straggler(0.105)
    assert mon.is_straggler(0.5)


def test_straggler_escalates_after_persistent_flags():
    hits = []
    mon = StragglerMonitor(StragglerConfig(window=20, mad_k=4, min_samples=5,
                                           persistent_threshold=3),
                           host_id=2, on_straggler=lambda h, dt: hits.append(h))
    for _ in range(10):
        mon.record(0.1)
    for _ in range(3):
        mon.record(0.5)
    assert hits == [2] and mon.stats()["flags"] == 3
    with mon.step_timer():
        pass
    assert len(mon.times) == 14


def test_aggregate_host_times():
    times = {0: 0.1, 1: 0.11, 2: 0.1, 3: 0.98}
    assert aggregate_host_times(times) == [3]
