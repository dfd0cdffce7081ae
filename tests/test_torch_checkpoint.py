"""Checkpoints cross the two packages: a train state or a best.npz saved by
either loads in the other with every array equal, and the npz key sets are
the same (tiny config; arrays from a numpy seed)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.core import checkpoint as jckpt
from neighborretr_tpu.core import config as jc
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu.train import bertadam as jadam
from neighborretr_tpu.train import memory_bank as jmb
from neighborretr_tpu.train import step as jstep
from neighborretr_tpu_torch.core import checkpoint as tckpt
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.train import memory_bank as tmb
from neighborretr_tpu_torch.train import step as tstep

WORDS, FRAMES, CAP = 8, 4, 16


def random_like(rng, tree, positive=False):
    def draw(x):
        a = rng.normal(size=np.shape(x)).astype(np.float32)
        return jnp.asarray(np.abs(a) if positive else a)
    return jax.tree.map(draw, tree)


def random_bank(rng, width):
    return (rng.integers(0, 1000, CAP).astype(np.int32),
            rng.normal(size=(CAP, WORDS, width)).astype(np.float32),
            rng.normal(size=(CAP, FRAMES, width)).astype(np.float32),
            (rng.uniform(size=(CAP, WORDS)) > 0.3).astype(np.float32),
            (rng.uniform(size=(CAP, FRAMES)) > 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def jax_state():
    """A JAX train state with random parameters, moments, bank and steps."""
    rng = np.random.default_rng(0)
    m = jc.ModelConfig.tiny(max_words=WORDS, max_frames=FRAMES)
    params = random_like(rng, jm.init_params(jax.random.PRNGKey(0), m))
    opt = jadam.BertAdamState(step=jnp.asarray(7, jnp.int32),
                              m=random_like(rng, params),
                              v=random_like(rng, params, positive=True))
    bank = jmb.MemoryBank(*map(jnp.asarray, random_bank(rng, m.width)))
    return jstep.TrainState(params=params, opt=opt, bank=bank,
                            step=jnp.asarray(7, jnp.int32))


def fresh_torch_state(seed=1):
    m = tc.ModelConfig.tiny(max_words=WORDS, max_frames=FRAMES)
    model = W.init_model(m, seed)
    return tstep.create_train_state(model, tmb.create(CAP, WORDS, FRAMES,
                                                      m.width))


def npz(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def test_jax_state_loads_in_the_port_and_saves_back_identically(tmp_path,
                                                                jax_state):
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jckpt.save_train_state(a, jax.device_get(jax_state))
    state = tckpt.load_train_state(a, fresh_torch_state())
    assert state.step == 7 and state.opt.step == 7
    assert isinstance(state.step, int)
    tckpt.save_train_state(b, state)
    want, got = npz(a), npz(b)
    assert set(got) == set(want)                # the key layout is shared
    assert {"opt_step", "step", "bank//ind", "bank//feat_t"} <= set(got)
    assert any(k.startswith("params//clip//visual//") for k in got)
    assert any(k.startswith("opt_m//") for k in got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # what was loaded is what the model and the optimizer now hold
    sd = W.state_dict_from_jax_params(jax.device_get(jax_state.params),
                                      state.model.cfg)
    for name, p in state.model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), sd[name], err_msg=name)
    m_sd = W.state_dict_from_jax_params(jax.device_get(jax_state.opt.m),
                                        state.model.cfg)
    for name, t in state.opt.m.items():
        np.testing.assert_array_equal(t.numpy(), m_sd[name], err_msg=name)
    np.testing.assert_array_equal(state.bank.mask_v.numpy(),
                                  np.asarray(jax_state.bank.mask_v))
    assert state.bank.ind.dtype == torch.int32


def test_port_state_loads_in_jax(tmp_path, jax_state):
    rng = np.random.default_rng(3)
    state = fresh_torch_state(seed=2)
    for t in list(state.opt.m.values()) + list(state.opt.v.values()):
        t.copy_(torch.as_tensor(rng.normal(size=tuple(t.shape)) ** 2))
    width = state.model.cfg.width
    state.bank = tmb.MemoryBank(*map(torch.as_tensor, random_bank(rng, width)))
    state.step = 5
    state.opt = state.opt._replace(step=5)
    path = str(tmp_path / "torch.npz")
    tckpt.save_train_state(path, state)

    loaded = jckpt.load_train_state(path, jax.device_get(jax_state))
    assert int(loaded.step) == 5 and int(loaded.opt.step) == 5
    want = W.to_jax_params(state.model.state_dict(), state.model.cfg)
    flat_got = jax.tree_util.tree_flatten_with_path(loaded.params)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_got) == len(flat_want) > 50
    for (pa, a), (pb, b) in zip(flat_got, flat_want):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(pa))
    v_want = W.to_jax_params(state.opt.v, state.model.cfg)
    for a, b in zip(jax.tree.leaves(loaded.opt.v), jax.tree.leaves(v_want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(loaded.bank, state.bank):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_best_npz_crosses_both_ways(tmp_path, jax_state):
    a, b = str(tmp_path / "jax_best.npz"), str(tmp_path / "torch_best.npz")
    params = jax.device_get(jax_state.params)
    jckpt.save_params(a, params)
    model = W.load_checkpoint(a, tc.ModelConfig.tiny(max_words=WORDS,
                                                     max_frames=FRAMES))
    tckpt.save_params(b, model)
    want, got = npz(a), npz(b)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = jckpt.load_params(b, params)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # a full train state serves as a parameter file too
    s = str(tmp_path / "state.npz")
    jckpt.save_train_state(s, jax.device_get(jax_state))
    tree = tckpt.load_params(s, tckpt.params_tree(model))
    np.testing.assert_array_equal(tree["clip"]["text"]["text_projection"],
                                  np.asarray(params["clip"]["text"]
                                             ["text_projection"]))


def test_warm_start_report_and_bfloat16_round_trip(tmp_path):
    state = fresh_torch_state()
    tree = tckpt.params_tree(state.model)
    flat = tckpt.flatten_tree(tree)
    flat.pop("clip//logit_scale")
    flat["extra//leaf"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="logit_scale"):
        tckpt.unflatten_into(tree, flat)
    flat["clip//text//text_projection"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.unflatten_into(tree, flat)
    got, report = tckpt.unflatten_into(tree, flat, strict=False)
    assert report["missing"] == ["clip//logit_scale"]
    assert report["unexpected"] == ["extra//leaf"]
    assert len(report["mismatched"]) == 1
    np.testing.assert_array_equal(got["clip"]["text"]["text_projection"],
                                  tree["clip"]["text"]["text_projection"])
    # bf16 moments and bank rows are stored as fp32 and come back as bf16
    m = state.model.cfg
    bf = tstep.create_train_state(
        state.model, tmb.create(CAP, WORDS, FRAMES, m.width,
                                feat_dtype=torch.bfloat16),
        moments_dtype="bfloat16")
    for t in bf.opt.m.values():
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(1)))
    path = str(tmp_path / "bf16.npz")
    tckpt.save_train_state(path, bf)
    assert npz(path)["bank//feat_t"].dtype == np.float32
    back = tckpt.load_train_state(path, bf)
    name = "clip.text_projection"
    assert back.opt.m[name].dtype == torch.bfloat16
    assert back.bank.feat_t.dtype == torch.bfloat16
    assert torch.equal(back.opt.m[name], bf.opt.m[name])


def test_latest_resumable_and_atomic_async_writes(tmp_path):
    out = str(tmp_path)
    assert tckpt.latest_resumable(out) is None
    state = fresh_torch_state()
    writer = tckpt.AsyncWriter()
    for step, name in ((2, "state_epoch0.npz"), (4, "state_epoch1.npz"),
                       (3, "state_preempt.npz")):
        state.step = step
        payload = tckpt.train_state_payload(state)
        writer.submit(lambda p=payload, n=name: tckpt._atomic_savez(
            os.path.join(out, n), p))
    writer.close()
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    assert tckpt.latest_resumable(out).endswith("state_epoch1.npz")
    state.step = 4                      # a tie prefers the preempt file
    tckpt.save_train_state(os.path.join(out, "state_preempt.npz"), state)
    assert tckpt.latest_resumable(out).endswith("state_preempt.npz")
    with open(os.path.join(out, "state_epoch9.npz"), "wb") as f:
        f.write(b"truncated")           # unreadable candidates are skipped
    assert tckpt.latest_resumable(out).endswith("state_preempt.npz")
    # a payload is a copy: a later in-place update does not reach it
    p = state.model.clip.text_projection
    payload = tckpt.train_state_payload(state)
    before = payload["params//clip//text//text_projection"].copy()
    with torch.no_grad():
        p.add_(1.0)
    np.testing.assert_array_equal(
        payload["params//clip//text//text_projection"], before)
    failing = tckpt.AsyncWriter()
    failing.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(OSError, match="disk full"):
        failing.close()
