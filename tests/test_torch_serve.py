"""The PyTorch port's serving engine against the JAX package's.

Both engines get the same requests and the same weights (the JAX model's
float32 reduced-config parameters, carried across by
``convert.model_params_from_reference``), and their greedy tokens must be
equal, token for token, through admission, batched decode with per-slot
positions, and slot reuse: the dense, MoE (idle slots' dummy tokens take
expert capacity in both engines) and RWKV families, GQA and MLA caches
(the latter ``c_kv``/``k_rope``, read and written through the same slot
views).  The cases of ``tests/test_serve.py``'s ``TestServeEngine`` are
ported beside them.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import build as jbuild  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCHS = ["stablelm-1.6b", "rwkv6-3b", "minicpm3-4b", "granite-moe-1b-a400m",
         "deepseek-v2-lite-16b"]


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _models(arch):
    jm = jbuild(dataclasses.replace(jconfigs.reduced(arch), dtype="float32"))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build(dataclasses.replace(configs.reduced(arch), dtype="float32"),
               device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(
        tm.cfg, jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _serve(engine, requests, admit, tick):
    """Admit in arrival order while slots are free, tick, repeat."""
    pending = list(requests)
    for _ in range(1000):
        while pending and admit(engine, pending[0]):
            pending.pop(0)
        if not pending and engine.active_slots == 0:
            return
        tick(engine)
    raise AssertionError("engine did not drain")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax_engine(arch):
    """Five requests of ragged lengths through three slots: two are
    admitted only once earlier ones finish, into reused slots."""
    jm, params, tm = _models(arch)
    rng = np.random.default_rng(7)
    specs = [(rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32), m)
             for n, m in ((5, 4), (11, 3), (3, 6), (8, 2), (14, 5))]
    jreqs = [JRequest(i, p, m) for i, (p, m) in enumerate(specs)]
    treqs = [Request(i, p, m) for i, (p, m) in enumerate(specs)]
    _serve(JServeEngine(jm, num_slots=3, cache_len=48), jreqs,
           lambda e, r: e.try_admit(params, r), lambda e: e.tick(params))
    _serve(ServeEngine(tm, num_slots=3, cache_len=48), treqs,
           lambda e, r: e.try_admit(r), lambda e: e.tick())
    for j, t in zip(jreqs, treqs):
        assert t.done and j.done
        assert t.generated == j.generated, (arch, t.rid)


def _engine(num_slots=3, cache_len=48):
    model = build(configs.reduced("stablelm-1.6b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    return model, ServeEngine(model, num_slots=num_slots, cache_len=cache_len)


def test_batched_requests_complete():
    model, eng = _engine()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, 5 + i).astype(np.int32),
                    max_new_tokens=4) for i in range(3)]
    for r in reqs:
        assert eng.try_admit(r)
    assert eng.active_slots == 3
    for _ in range(10):
        eng.tick()
        if all(r.done for r in reqs):
            break
    assert all(r.done for r in reqs)
    for r in reqs:
        assert len(r.generated) >= r.max_new_tokens
    assert eng.active_slots == 0


def test_engine_matches_sequential_decode():
    """Engine greedy decode == manual prefill + decode for one request."""
    model, eng = _engine(num_slots=2)
    prompt = np.random.default_rng(1).integers(0, 256, 6).astype(np.int32)
    req = Request(rid=0, prompt=prompt, max_new_tokens=3)
    assert eng.try_admit(req)
    while not req.done:
        eng.tick()

    cache = model.init_cache(1, 48)
    logits, cache = model.apply(torch.from_numpy(prompt)[None],
                                mode="prefill", cache=cache, pos=0)
    toks = [int(logits[0, -1].argmax())]
    pos = len(prompt)
    for _ in range(2):
        logits, cache = model.apply(torch.tensor([[toks[-1]]]), mode="decode",
                                    cache=cache, pos=pos)
        toks.append(int(logits[0, 0].argmax()))
        pos += 1
    assert req.generated[:3] == toks


def test_slot_reuse_after_completion():
    model, eng = _engine(num_slots=1)
    rng = np.random.default_rng(2)
    r1 = Request(0, rng.integers(0, 256, 4).astype(np.int32), 2)
    r2 = Request(1, rng.integers(0, 256, 4).astype(np.int32), 2)
    assert eng.try_admit(r1)
    assert not eng.try_admit(r2)  # pool full
    while not r1.done:
        eng.tick()
    assert eng.try_admit(r2)      # slot freed


def test_prefill_writes_only_its_slot():
    """A prefill through a slot view leaves the other slots' cache as it
    was, and fills its own slot up to the prompt's length."""
    model, eng = _engine(num_slots=3)
    rng = np.random.default_rng(3)
    first = Request(0, rng.integers(0, 256, 7).astype(np.int32), 3)
    assert eng.try_admit(first)
    before = {k: t.clone() for k, t in eng.cache.items()}
    second = Request(1, rng.integers(0, 256, 5).astype(np.int32), 3)
    assert eng.try_admit(second)
    for name, t in eng.cache.items():
        assert torch.equal(t[:, 0], before[name][:, 0]), name
        assert torch.equal(t[:, 2], before[name][:, 2]), name
        assert t[:, 1, :5].abs().sum() > 0 and not t[:, 1, 5:].any()
    np.testing.assert_array_equal(eng.slot_pos, [7, 5, 0])


def test_mla_prefill_writes_only_its_slot():
    """The MLA cache (latent and rope key) through a slot view: a prefill
    leaves the other slots as they were."""
    model = build(configs.reduced("deepseek-v2-lite-16b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    eng = ServeEngine(model, num_slots=3, cache_len=24)
    assert set(eng.cache) == {"c_kv", "k_rope"}
    rng = np.random.default_rng(4)
    assert eng.try_admit(Request(0, rng.integers(0, 256, 6).astype(np.int32),
                                 2))
    before = {k: t.clone() for k, t in eng.cache.items()}
    assert eng.try_admit(Request(1, rng.integers(0, 256, 4).astype(np.int32),
                                 2))
    for name, t in eng.cache.items():
        assert torch.equal(t[:, 0], before[name][:, 0]), name
        assert torch.equal(t[:, 2], before[name][:, 2]), name
        assert t[:, 1, :4].abs().sum() > 0 and not t[:, 1, 4:].any()
