"""The port's encoder-decoder (``repro_torch/models/encdec.py``, the cross
attention of ``models/layers.py``, ``get_api``'s audio branch) against the
JAX package on SMOKE ``whisper-tiny``, with JAX's init converted through
numpy.

Tolerances: fp32 within JAX's family tolerance (rtol 2e-3, atol 2e-4,
``tests/test_archs.py``'s decode-against-forward); bf16 within 2% of the
output's RMS in RMS error (ROADMAP queue 3, item 13: the port rounds after
each operation, XLA once per fused chain).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import api as japi  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import api, serve  # noqa: E402
from repro_torch.models import convert, encdec, layers, module  # noqa: E402

RTOL, ATOL = 2e-3, 2e-4
B, S, S_ENC = 2, 12, 24


def _setup(dtype="float32", **kw):
    jcfg = jconfigs.get_smoke("whisper-tiny").replace(dtype=dtype, **kw)
    cfg = configs.get_smoke("whisper-tiny").replace(dtype=dtype, **kw)
    jp = jax_init_params(jed.encdec_param_spec(jcfg), jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jcfg, cfg, jp, p


def _inputs(cfg, seed=3, s_enc=S_ENC):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, s_enc, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames, tokens


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rms_err(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.mark.parametrize("seq,d", [(1, 4), (24, 64), (1500, 384)])
def test_sinusoidal_positions_match_jax(seq, d):
    """fp32 angles reach seq - 1 radians (one ulp is 1.2e-4 at 1500), and
    the two libraries' sin, cos and pow round differently: within 1e-5."""
    got = layers.sinusoidal_positions(seq, d).numpy()
    want = np.asarray(jlayers.sinusoidal_positions(seq, d))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_spec_and_converted_tree_match_jax():
    jcfg, cfg, jp, p = _setup()
    assert encdec.MAX_DEC_POS == jed.MAX_DEC_POS
    want = module.leaves(encdec.encdec_param_spec(cfg))
    got = module.leaves(p)
    assert got.keys() == want.keys()
    for path, s in want.items():
        assert tuple(got[path].shape) == s.shape
    back = convert.lm_params_to_numpy(p)
    for path, t in module.leaves(back).items():
        np.testing.assert_array_equal(t, np.asarray(module.leaves(jp)[path]))


@pytest.mark.parametrize("q_chunk", [512, 16], ids=["one-chunk", "ragged"])
def test_encode_and_decode_forward_match_jax_fp32(q_chunk):
    """``q_chunk=16`` at 40 frames: JAX halves the chunk to 8 (5 chunks),
    the port's encoder takes 16, 16 and 8 rows (ROADMAP queue 3, item
    21); the outputs agree within the tolerance."""
    jcfg, cfg, jp, p = _setup(q_chunk=q_chunk)
    frames, tokens = _inputs(cfg, s_enc=40)
    jmem = jed.encode(jp, jnp.asarray(frames), jcfg)
    mem = encdec.encode(p, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(_f32(mem), _f32(jmem), rtol=RTOL, atol=ATOL)
    jlog, (jskv, jmkv) = jed.decode_forward(jp, jnp.asarray(tokens), jmem,
                                           jcfg, return_cache=True)
    log, (skv, mkv) = encdec.decode_forward(p, torch.from_numpy(tokens), mem,
                                            cfg, return_cache=True)
    np.testing.assert_allclose(_f32(log), _f32(jlog), rtol=RTOL, atol=ATOL)
    for got, want in zip(skv + mkv, jskv + jmkv):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)
    plain = encdec.decode_forward(p, torch.from_numpy(tokens), mem, cfg)
    assert torch.equal(plain, log)


def test_encode_and_decode_forward_match_jax_bf16():
    """The memory within 2% of its RMS (item 13). The logits are held to
    the reference's own bf16 error, as the recurrent archs' are: at SMOKE
    width JAX's bf16 logits are ~26% of the RMS from its fp32 ones (the
    port's ~14% from JAX's bf16); fed JAX's memory, the port's decoder is
    within 3%."""
    jcfg, cfg, jp, p = _setup(dtype="bfloat16")
    j32, _, jp32, _ = _setup()
    frames, tokens = _inputs(cfg)
    jmem = jed.encode(jp, jnp.asarray(frames), jcfg)
    mem = encdec.encode(p, torch.from_numpy(frames), cfg)
    assert mem.dtype == torch.bfloat16
    assert _rms_err(mem, jmem) < 2e-2
    jlog = jed.decode_forward(jp, jnp.asarray(tokens), jmem, jcfg)
    log = encdec.decode_forward(p, torch.from_numpy(tokens), mem, cfg)
    assert log.dtype == torch.bfloat16
    jlog32 = jed.decode_forward(jp32, jnp.asarray(tokens),
                                jed.encode(jp32, jnp.asarray(frames), j32), j32)
    assert _rms_err(log, jlog) < _rms_err(jlog, jlog32)
    on_jax_memory = encdec.decode_forward(
        p, torch.from_numpy(tokens), torch.from_numpy(_f32(jmem).copy()).bfloat16(), cfg)
    assert _rms_err(on_jax_memory, jlog) < 3e-2


def test_decode_step_loop_equals_decode_forward_and_jax():
    """Prefill the memory's keys and values, then ``encdec_decode_step``
    token by token: each step's logits equal the teacher-forced pass's
    and JAX's step's; the self-attention rows land in the cache in
    place."""
    jcfg, cfg, jp, p = _setup()
    frames, tokens = _inputs(cfg)
    mem = encdec.encode(p, torch.from_numpy(frames), cfg)
    full, (_, (mk, mv)) = encdec.decode_forward(
        p, torch.from_numpy(tokens), mem, cfg, return_cache=True)
    cache = encdec.encdec_init_cache(cfg, B, S, S_ENC, device="cpu")
    cache["mk"].copy_(mk)
    cache["mv"].copy_(mv)
    jcache = jed.encdec_init_cache(jcfg, B, S, S_ENC)
    jcache = {**jcache, "mk": jnp.asarray(mk.numpy()), "mv": jnp.asarray(mv.numpy())}
    k_store = cache["k"]
    for t in range(S):
        tok = torch.from_numpy(tokens[:, t:t + 1])
        lg, cache = encdec.encdec_decode_step(p, cache, tok, t, cfg)
        jlg, jcache = jed.encdec_decode_step(jp, jcache, jnp.asarray(tokens[:, t:t + 1]),
                                             jnp.int32(t), jcfg)
        np.testing.assert_allclose(_f32(lg[:, 0]), _f32(full[:, t]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(_f32(lg), _f32(jlg), rtol=RTOL, atol=ATOL)
    assert cache["k"] is k_store  # written in place
    for name in ("k", "v", "mk", "mv"):
        np.testing.assert_allclose(_f32(cache[name]), _f32(jcache[name]),
                                   rtol=RTOL, atol=ATOL)


def test_get_api_audio_branch_and_cache_shapes():
    jcfg, cfg, jp, p = _setup()
    a, ja = api.get_api(cfg), japi.get_api(jcfg)
    assert api.ModelAPI._fields == japi.ModelAPI._fields
    assert a.loss_fn is encdec.encdec_loss_fn
    assert module.leaves(a.param_spec()).keys() == module.leaves(
        encdec.encdec_param_spec(cfg)).keys()
    for enc_len in (None, 8):
        got = a.init_cache(B, 16, enc_len=enc_len, device="cpu")
        want = ja.init_cache(B, 16, enc_len=enc_len)
        assert got.keys() == want.keys()
        for name in want:
            assert tuple(got[name].shape) == want[name].shape
            assert got[name].dtype == cfg.compute_dtype
    frames, tokens = _inputs(cfg)
    batch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}
    logits, (self_kv, mem_kv) = a.prefill_fn(p, batch)
    jlogits, (jself, jmem) = ja.prefill_fn(jp, {k: jnp.asarray(v.numpy())
                                               for k, v in batch.items()})
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=RTOL, atol=ATOL)
    assert [tuple(t.shape) for t in self_kv + mem_kv] == [
        t.shape for t in jself + jmem]
    lg, _ = a.decode_fn(p, a.init_cache(B, 4, enc_len=S_ENC, device="cpu"),
                        batch["tokens"][:, :1], 0)
    assert lg.shape == (B, 1, cfg.vocab_size)


def test_launch_serve_raises_jaxs_system_exit_for_audio():
    with pytest.raises(SystemExit) as jexc:
        jserve.main(["--arch", "whisper-tiny", "--smoke"])
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu"])
    assert str(exc.value) == str(jexc.value)


def test_whisper_full_stack():
    """Port of ``tests/test_archs.py::test_whisper_full_stack`` on the
    port's seeded init."""
    cfg = configs.get_smoke("whisper-tiny")
    params = module.init_params(encdec.encdec_param_spec(cfg), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    memory = encdec.encode(params, frames, cfg)
    assert memory.shape == (2, 24, cfg.d_model)
    logits = encdec.decode_forward(params, tokens, memory, cfg)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
