"""The port's training substrate (``repro_torch.train``), mirroring
``tests/test_train.py`` — optimizer, accumulation, data determinism,
checkpoint/restart, straggler detection, heartbeat — plus the data
pipeline equal to the reference's element for element and remat
``none`` == ``dots`` == ``full`` bit for bit.  The cross-framework cases
against the JAX package are in ``tests/test_torch_train_parity.py``."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.train import data as JD
from repro_torch import configs
from repro_torch.configs.base import smoke_variant
from repro_torch.models import params as PP
from repro_torch.models import registry
from repro_torch.train import (checkpoint as CK, data as D, fault as F,
                               optimizer as OPT, train_loop as TL)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfg():
    return smoke_variant(configs.get("minitron-4b"))


@pytest.fixture(scope="module")
def jax_weights():
    """The reference test's weights: ``repro.models.registry.init(cfg,
    0)`` as numpy arrays, bridged with ``params_from_numpy``."""
    import jax
    from repro import configs as JC
    from repro.configs.base import smoke_variant as jsmoke
    from repro.models import registry as JR
    return jax.tree.map(np.asarray,
                        JR.init(jsmoke(JC.get("minitron-4b")), 0))


def _init(cfg, dtype=None):
    return registry.init(cfg, 0, device="cpu", dtype=dtype)


def _batch(cfg, dcfg, step):
    return {k: torch.from_numpy(v) for k, v in
            D.make_batch(cfg, dcfg, step).items()}


def test_loss_decreases(cfg, jax_weights):
    """The reference test's weights, data and schedule: the loss after
    15 steps is below the first."""
    params = PP.params_from_numpy(jax_weights, "cpu")
    opt_state = OPT.init(params)
    step_fn = TL.make_train_step(
        cfg, TL.TrainCfg(opt=OPT.OptCfg(lr=1e-3, warmup_steps=5,
                                        total_steps=50)))
    dcfg = D.DataCfg(global_batch=4, seq_len=32)
    losses = []
    for s in range(15):
        params, opt_state, m = step_fn(params, opt_state,
                                       _batch(cfg, dcfg, s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(loss) for loss in losses)
    assert int(opt_state.step) == 15


def test_grad_accum_matches_full_batch(cfg):
    """grad_accum=2 equals the single-batch step: loss to the
    reference's 5e-3, gradient norm to 1e-5 relative (a dropped divide
    doubles it), parameters to the reference's rtol 2e-2, atol 2e-4 at
    lr 1e-3 with warmup 1, where the step moves an element by ~1e-3 (a
    lost microbatch flips signs).  The accumulating step against the
    reference's is in ``tests/test_torch_train_parity.py``."""
    batch = _batch(cfg, D.DataCfg(global_batch=4, seq_len=32), 0)
    oc = OPT.OptCfg(lr=1e-3, warmup_steps=1, total_steps=10)
    outs = []
    for accum in (1, 2):
        p = _init(cfg)
        before = [x.clone() for x in OPT.sorted_leaves(p)]
        fn = TL.make_train_step(cfg, TL.TrainCfg(opt=oc, grad_accum=accum,
                                                 compress_grads=False))
        p2, _, m = fn(p, OPT.init(p), batch)
        outs.append((p2, float(m["loss"]), float(m["grad_norm"])))
    assert max(float((a - b).abs().max()) for a, b in
               zip(before, OPT.sorted_leaves(p2))) > 5e-4
    assert abs(outs[0][1] - outs[1][1]) < 5e-3
    assert outs[1][2] == pytest.approx(outs[0][2], rel=1e-5)
    for a, b in zip(OPT.sorted_leaves(outs[0][0]),
                    OPT.sorted_leaves(outs[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-4)


def test_grad_accum_needs_a_divisible_batch(cfg):
    fn = TL.make_train_step(cfg, TL.TrainCfg(grad_accum=3))
    p = _init(cfg)
    with pytest.raises(ValueError, match="grad_accum"):
        fn(p, OPT.init(p), _batch(cfg, D.DataCfg(global_batch=4,
                                                 seq_len=8), 0))


def test_schedule_warmup_cosine():
    oc = OPT.OptCfg(lr=1e-3, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    assert OPT.schedule(oc, 0) < 2e-4
    assert OPT.schedule(oc, torch.tensor(10)) == pytest.approx(1e-3,
                                                               rel=1e-3)
    assert OPT.schedule(oc, 100) == pytest.approx(1e-4, rel=1e-2)


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 10.0}
    clipped, norm = OPT.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    np.testing.assert_allclose(clipped["a"].numpy(), np.full(4, 0.5),
                               rtol=1e-5)


def test_update_in_slices_equals_whole_leaves(monkeypatch):
    """Slicing a leaf (``CHUNK``) changes nothing elementwise: the same
    bits as one slice per leaf; only the norm's sum order may move."""
    rng = np.random.default_rng(0)
    params = {"a": torch.from_numpy(rng.standard_normal((7, 5)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(
            (11,)).astype(np.float32)).to(torch.bfloat16)}
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) for k, v in params.items()}
    oc = OPT.OptCfg(lr=1e-2, warmup_steps=1, clip_norm=1e9)
    whole = {k: v.clone() for k, v in params.items()}
    OPT.update(oc, grads, OPT.init(whole), whole)
    monkeypatch.setattr(OPT, "CHUNK", 3)
    sliced = {k: v.clone() for k, v in params.items()}
    state = OPT.init(sliced)
    _, state, m = OPT.update(oc, grads, state, sliced)
    for k in params:
        assert torch.equal(whole[k], sliced[k]), k
        assert sliced[k].dtype == params[k].dtype
    assert int(state.step) == 1 and state.m["b"].dtype == torch.float32


def test_data_pipeline_deterministic_and_sharded(cfg):
    d0 = D.DataCfg(global_batch=8, seq_len=16, host_index=0, host_count=2)
    d1 = D.DataCfg(global_batch=8, seq_len=16, host_index=1, host_count=2)
    a = D.make_batch(cfg, d0, 5)
    b = D.make_batch(cfg, d0, 5)
    c = D.make_batch(cfg, d1, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("arch", ["minitron-4b", "paligemma-3b",
                                  "musicgen-medium"])
def test_data_equals_the_reference(arch):
    """Tokens, labels, patches and cond equal
    ``repro.train.data.make_batch``'s, dtype and element for element,
    per host shard; and ``registry.make_batch`` equals the reference
    registry's draws (bf16 bits for patches and cond)."""
    from repro import configs as JC
    from repro.configs.base import smoke_variant as jsmoke
    from repro.models import registry as JR
    cfg = smoke_variant(configs.get(arch))
    jcfg = jsmoke(JC.get(arch))
    for host in (0, 1):
        mine = D.make_batch(cfg, D.DataCfg(4, 24, 3, host, 2), 7)
        ref = JD.make_batch(jcfg, JD.DataCfg(4, 24, 3, host, 2), 7)
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert mine[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(mine[k], ref[k])
    for kind in ("train", "prefill", "decode"):
        mine = registry.make_batch(cfg, kind, 2, 16, seed=4, device="cpu")
        ref = JR.make_batch(jcfg, kind, 2, 16, seed=4)
        assert sorted(mine) == sorted(ref)
        for k, r in ref.items():
            r = np.asarray(r)
            t = mine[k]
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy(), r.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), r)


def test_data_pipeline_stream_overlap(cfg):
    pipe = D.DataPipeline(cfg, D.DataCfg(global_batch=2, seq_len=8),
                          depth=2, num_steps=5)
    try:
        batches = [pipe.next() for _ in range(5)]
    finally:
        pipe.close()
    assert len(batches) == 5
    assert not pipe._thread.is_alive()
    ref = D.make_batch(cfg, D.DataCfg(global_batch=2, seq_len=8), 0)
    np.testing.assert_array_equal(batches[0]["tokens"], ref["tokens"])


def _state_equal(a, b):
    la, lb = OPT.sorted_leaves(a), OPT.sorted_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


def test_checkpoint_atomic_and_exact(cfg, tmp_path):
    """Round trip bit for bit, bf16 leaves included (stored as their
    uint16 bits), in the reference's layout; prune keeps the newest."""
    params = _init(cfg, torch.bfloat16)
    state = {"params": params, "opt": OPT.init(params)}
    CK.save(str(tmp_path), 3, state, extra={"cfg": cfg.name})
    CK.save(str(tmp_path), 7, state)
    assert CK.latest_step(str(tmp_path)) == 7
    assert (tmp_path / "LATEST").read_text() == "step_000000007"
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]
    restored, step, extra = CK.restore(str(tmp_path), state, step=3)
    assert step == 3 and extra == {"cfg": cfg.name}
    _state_equal(restored, state)
    assert isinstance(restored["opt"], OPT.OptState)
    import json
    manifest = json.loads((tmp_path / "step_000000003" /
                           "MANIFEST.json").read_text())
    assert manifest["leaves"]["params/embed"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["opt/m/embed"]["dtype"] == "float32"
    CK.prune(str(tmp_path), keep=1)
    assert CK.latest_step(str(tmp_path)) == 7
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path), state, step=3)
    bad = {"params": {**params, "final_norm": torch.zeros(3)},
           "opt": state["opt"]}
    with pytest.raises(ValueError, match="shape"):
        CK.restore(str(tmp_path), bad)


def _supervised(cfg, ckpt_dir, fail_at):
    dcfg = D.DataCfg(global_batch=2, seq_len=16)
    step_fn = TL.make_train_step(cfg, TL.TrainCfg())

    def wrapped(state, batch):
        p, o = state
        p, o, m = step_fn(p, o, batch)
        return (p, o), m

    p = _init(cfg)
    sup = F.TrainSupervisor(wrapped, (p, OPT.init(p)), str(ckpt_dir),
                            save_every=4)
    rep = sup.run(lambda s: _batch(cfg, dcfg, s), num_steps=12,
                  fail_at=fail_at)
    return sup, rep


def test_supervisor_restart_bit_exact(cfg, tmp_path):
    """Failures before steps 6 and 10, each restored from the last
    checkpoint (4 and 8): the final state equals the uninterrupted run's
    bit for bit."""
    ref, rep_ref = _supervised(cfg, tmp_path / "ref", ())
    ft, rep = _supervised(cfg, tmp_path / "ft", (6, 10))
    assert rep_ref.restarts == 0 and rep.restarts == 2
    assert rep.steps_run == 12 + 2 + 2
    _state_equal(ft.state, ref.state)


def test_supervisor_gives_up_on_a_recurring_fault(cfg, tmp_path):
    def broken(state, batch):
        raise RuntimeError("device lost")
    sup = F.TrainSupervisor(broken, {"x": torch.zeros(1)}, str(tmp_path))
    with pytest.raises(RuntimeError, match="device lost"):
        sup.run(lambda s: None, num_steps=2)
    assert sup.report.restarts == F.MAX_RESTARTS


def test_straggler_detector():
    det = F.StragglerDetector(warmup=3)
    flags = [det.observe(1.0) for _ in range(10)]
    assert not any(flags)
    assert det.observe(10.0)


def test_heartbeat():
    hb = F.Heartbeat(["w0", "w1"], timeout=0.2)
    hb.beat("w0")
    time.sleep(0.3)
    hb.beat("w1")
    assert hb.dead() == ["w0"]
    assert hb.alive() == ["w1"]


class _CountMatmuls(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the products with no batch dims (``mm``, ``addmm``) run
    while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["minitron-4b", "zamba2-1p2b",
                                  "deepseek-v2-lite-16b"])
def test_remat_changes_no_bit(arch):
    """remat none, dots and full: the same loss and gradients bit for
    bit (recomputation changes memory, never values).  After the
    forward, autograd holds less under dots and full than under none;
    the backward recomputes matmuls under full only (dots kept their
    outputs)."""
    base = smoke_variant(configs.get(arch))
    params = _init(base)
    batch = registry.make_batch(base, "train", 2, 16, seed=1, device="cpu")
    out, saved, bwd_mm = {}, {}, {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        out[remat] = TL.value_and_grad(cfg, params, batch)
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t

        live = PP.tree_map(lambda _, p: p.detach().requires_grad_(), params)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = TL.loss_fn(cfg, live, batch)
        saved[remat] = sum(nbytes)
        with _CountMatmuls() as count:
            torch.autograd.grad(loss, PP.tree_leaves(live))
        bwd_mm[remat] = count.n
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(OPT.sorted_leaves(out[remat][1]),
                        OPT.sorted_leaves(out["none"][1])):
            assert torch.equal(a, b), remat
    assert saved["dots"] < saved["none"] and saved["full"] < saved["none"]
    assert bwd_mm["dots"] == bwd_mm["none"] < bwd_mm["full"]


def test_unknown_remat_is_refused(cfg):
    p = _init(cfg)
    bad = dataclasses.replace(cfg, remat="some")
    with pytest.raises(ValueError, match="remat"):
        TL.value_and_grad(bad, p, registry.make_batch(
            cfg, "train", 1, 8, device="cpu"))


def test_mesh_is_refused(cfg):
    """Sharded training waits for the tensor-parallel port (``use_pallas``
    on the recurrent families: ``tests/test_torch_train_recurrent.py``)."""
    with pytest.raises(NotImplementedError, match="A13"):
        TL.make_train_step(cfg, mesh=object())


def test_no_grad_is_left_on_the_parameters(cfg):
    params = _init(cfg)
    fn = TL.make_train_step(cfg)
    fn(params, OPT.init(params), _batch(cfg, D.DataCfg(2, 8), 0))
    assert all(p.grad is None and not p.requires_grad
               for p in OPT.sorted_leaves(params))


def test_cpu_wrappers_keep_their_gradients():
    """On the CPU a kernel wrapper runs its differentiable plain twin;
    on the card (a stand-in tensor here) it refuses an input that needs
    a gradient, and passes one under ``no_grad``."""
    import types
    from repro_torch.kernels import build, ops
    x = torch.randn(64, 2, 16, requires_grad=True)
    y = ops.ssd(x[None], torch.rand(1, 64, 2), -torch.rand(2),
                torch.randn(1, 64, 16), torch.randn(1, 64, 16), chunk=16,
                use_pallas=True)
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    card = types.SimpleNamespace(device=torch.device("cuda", 0),
                                 requires_grad=True)
    with pytest.raises(build.GradientError, match="ssd_scan"):
        build.on_cpu("ssd_scan", card)
    with torch.no_grad():
        assert build.on_cpu("ssd_scan", card) is False
    card.requires_grad = False
    assert build.on_cpu("ssd_scan", card) is False
