"""The trainer's host-memory paths on the CPU, against the JAX package:
the device prefetch (the same batches with the same look-ahead), the host
placements of the moments and the bank (refused on a CPU device in both
packages), and --debug_nans (a planted NaN raises FloatingPointError in
both packages; a clean step under it changes no bit).

On the CPU the prefetch converts each batch with the JAX deque's
look-ahead and no thread; its CUDA form (pinned slots, a copy stream,
events) and the placements' bit-equality are `gpu` tests in
tests/test_torch_gpu.py.  JAX's debug mode is scoped with
`jax.debug_nans(True)`: xdist reuses the process.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.core import config as jc
from neighborretr_tpu.data import device_prefetch as jpf
from neighborretr_tpu.data.datasets.synthetic import make_synthetic_batch
from neighborretr_tpu.train import bertadam as jba
from neighborretr_tpu.train import memory_bank as jmb
from neighborretr_tpu.train import step as jstep
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.data import device_prefetch as tpf
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.train import bertadam as tba
from neighborretr_tpu_torch.train import memory_bank as tmb
from neighborretr_tpu_torch.train import step as tstep

B = 8


class Counted:
    """A seeded numpy batch iterator that counts its `next()` calls."""

    def __init__(self, n: int, seed: int = 0):
        self.n, self.calls, self.made = n, 0, 0
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        self.calls += 1
        if self.made == self.n:
            raise StopIteration
        self.made += 1
        r = self.rng
        return {"text_ids": r.integers(0, 512, (4, 8)).astype(np.int32),
                "text_mask": (r.uniform(size=(4, 8)) > .3).astype(np.float32),
                "video": r.integers(0, 256, (4, 3, 8, 8, 3)).astype(np.uint8),
                "video_mask": np.ones((4, 3), np.float32),
                "idx": r.integers(0, 99, 4).astype(np.int32),
                "valid": np.ones(4, np.bool_),
                "video_hash": np.arange(4, dtype=np.int64)}


def drain(prefetch, src):
    """([(source next() calls at the yield, batch)], calls at the end)."""
    out = []
    for batch in prefetch:
        out.append((src.calls, batch))
    return out, src.calls


@pytest.mark.parametrize("n", [0, 1, 5])
@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_matches_jax_batches_and_look_ahead(size, n):
    jsrc, tsrc = Counted(n), Counted(n)
    jout, jcalls = drain(jpf.prefetch_to_device(jsrc, size=size), jsrc)
    tout, tcalls = drain(tpf.prefetch_to_device(tsrc, size=size,
                                                device="cpu"), tsrc)
    assert len(tout) == len(jout) == n
    assert tcalls == jcalls
    assert [c for c, _ in tout] == [c for c, _ in jout]
    for (_, jb), (_, tb) in zip(jout, tout):
        assert sorted(tb) == sorted(jb) == sorted(tpf.BATCH_KEYS)
        for k in jb:
            want = np.asarray(jb[k])
            got = tb[k].numpy()
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_host_placements_refused_on_a_cpu_device_in_both_packages():
    params = {"x": {"w": jnp.ones((3,))}}
    with pytest.raises(ValueError, match="TPU/GPU") as jmom:
        jba.place_moments(jba.bert_adam_init(params), "host")
    with pytest.raises(ValueError, match="TPU/GPU") as jbank:
        jmb.place_bank(jmb.create(4, 2, 2, 3), "host")
    state = tba.bert_adam_init({"x.w": torch.ones(3)})
    with pytest.raises(ValueError) as tmom:
        tba.place_moments(state, "host", "cpu")
    with pytest.raises(ValueError) as tbank:
        tmb.place_bank(tmb.create(4, 2, 2, 3), "host", "cpu")
    # the port's message opens with the JAX package's words, then says why
    for j, t in ((jmom, tmom), (jbank, tbank)):
        assert str(t.value).startswith(str(j.value).split(" (")[0])
    # the device placement is no placement at all, on any device
    assert tba.place_moments(state, "device", "cpu") is state
    bank = tmb.create(4, 2, 2, 3)
    assert tmb.place_bank(bank, "device", "cpu") is bank


def _configs():
    def make(mod):
        model = dc.replace(mod.ModelConfig.tiny(max_words=8, max_frames=4),
                           cluster_noise=False)
        return mod.Config(
            model=model, loss=mod.LossConfig(num_neighbors=3),
            optim=mod.OptimizerConfig(lr=1e-2, coef_lr=0.1),
            data=mod.DataConfig(max_words=8, max_frames=4),
            train=mod.TrainConfig(batch_size=B, mb_batch=1))
    return make(jc), make(tc)


def test_debug_nans_raises_in_both_packages_and_a_clean_step_is_unchanged():
    jcfg, tcfg = _configs()
    m = jcfg.model
    start = W.init_model(tcfg.model, 0).state_dict()
    batch = make_synthetic_batch(m, B, seed=3)
    cap = jcfg.train.memory_bank_capacity

    def port_model():
        model = W.init_model(tcfg.model, 0)
        model.load_state_dict(start)
        return model

    # the port: a clean step under the flag gives the bits of one without
    def port_step(model, debug):
        state = tstep.create_train_state(
            model, tmb.create(cap, m.max_words, m.max_frames, m.width))
        with tstep.debug_nans(debug):
            return tstep.train_step(state, tstep.to_device(batch, "cpu"),
                                    tcfg, 10)

    clean, flagged = port_model(), port_model()
    _, met = port_step(clean, False)
    _, met_flagged = port_step(flagged, True)
    assert not tstep._DEBUG_NANS[0]
    for k in met:
        assert torch.equal(met[k], met_flagged[k]), k
    for (n, a), b in zip(clean.state_dict().items(),
                         flagged.state_dict().values()):
        assert torch.equal(a, b), n

    # a NaN planted in one parameter: FloatingPointError naming it
    planted = port_model()
    with torch.no_grad():
        planted.clip.visual.proj[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="clip.visual.proj"):
        port_step(planted, True)

    # the JAX package, under its own flag, scoped to this block, from the
    # same weights with the same NaN
    bad = jax.tree.map(jnp.asarray, W.to_jax_params(
        planted.state_dict(), tcfg.model))
    assert bool(jnp.isnan(bad["clip"]["visual"]["proj"]).any())
    jstate = jstep.create_train_state(
        bad, jmb.create(cap, m.max_words, m.max_frames, m.width))
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jstep.train_step(jstate, jax.tree.map(jnp.asarray, batch),
                             jax.random.PRNGKey(0), jcfg, 10)


def test_debug_nans_checks_after_the_backward_and_replays_only_on_a_hit(
        monkeypatch):
    """--debug_nans at the JAX flag's cost: a clean step never turns on
    autograd's anomaly mode; a NaN that arises inside the step (here the KL
    term times NaN) is found before the optimizer update, the step's
    backward is replayed under anomaly mode, which names the op, and the
    parameters, moments and bank are the ones the step started from."""
    _, tcfg = _configs()
    m = tcfg.model
    seen = []
    poison = [False]
    real_kl = tstep.hubness.kl_divergence_loss

    def kl(*a, **kw):
        seen.append(torch.is_anomaly_enabled())
        out = real_kl(*a, **kw)
        return out * float("nan") if poison[0] else out

    monkeypatch.setattr(tstep.hubness, "kl_divergence_loss", kl)
    model = W.init_model(m, 0)
    state = tstep.create_train_state(model, tmb.create(
        tcfg.train.memory_bank_capacity, m.max_words, m.max_frames, m.width))
    batches = [tstep.to_device(make_synthetic_batch(m, B, seed=s), "cpu")
               for s in (5, 6)]
    with tstep.debug_nans(True):
        state, met = tstep.train_step(state, batches[0], tcfg, 10)
    assert seen and not any(seen)
    assert np.isfinite(met["loss"].item())

    before = ({n: p.detach().clone() for n, p in model.named_parameters()},
              {n: t.clone() for n, t in state.opt.m.items()},
              {n: t.clone() for n, t in state.opt.v.items()},
              [t.clone() for t in state.bank], state.opt.step)
    poison[0] = True
    seen.clear()
    with tstep.debug_nans(True):
        with pytest.raises(FloatingPointError, match="returned nan values"):
            tstep.train_step(state, batches[1], tcfg, 10)
    assert seen == [False, False, True, True]        # the step, its replay
    params, m_, v_, bank, opt_step = before
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
        assert p.grad is None, n
    for n in m_:
        assert torch.equal(state.opt.m[n], m_[n]), n
        assert torch.equal(state.opt.v[n], v_[n]), n
    assert all(torch.equal(a, b) for a, b in zip(state.bank, bank))
    assert state.opt.step == opt_step
