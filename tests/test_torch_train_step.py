"""The train-step slice as a whole against the JAX package, on the CPU:
bank fill, then three optimizer steps from the same weights, batches, bank
and noise draws in both packages (tiny config, fp32).

Every parameter tensor is held to 1e-4 absolute after the three steps, the
bar the JAX package's own trajectory tests hold against the reference; the
loss terms to 1e-4 relative; the bank to 1e-5.  Finiteness is asserted
separately (assert_allclose takes NaN == NaN as equal).  Each step gets its
own batch: one repeated batch degenerates the bank into the batch's own
features and both stacks go NaN at step 3.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.core import config as jc
from neighborretr_tpu.data.datasets.synthetic import make_synthetic_batch
from neighborretr_tpu.models import neighborretr as jm
from neighborretr_tpu.train import memory_bank as jmb
from neighborretr_tpu.train import step as jstep
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.models import neighborretr as tm
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.train import memory_bank as tmb
from neighborretr_tpu_torch.train import step as tstep

B, MB_BATCH, T_TOTAL, STEPS = 8, 2, 10, 3
LOSS_KEYS = ("loss", "centrality_loss", "uniform_loss", "neighbor_loss",
             "kl_loss")


def make_config(mod, cluster_noise=False):
    """The same configuration from either package's dataclasses."""
    model = dc.replace(mod.ModelConfig.tiny(max_words=8, max_frames=4),
                       cluster_noise=cluster_noise)
    return mod.Config(
        model=model, loss=mod.LossConfig(num_neighbors=3),
        optim=mod.OptimizerConfig(lr=1e-2, coef_lr=0.1),
        data=mod.DataConfig(max_words=8, max_frames=4),
        train=mod.TrainConfig(batch_size=B, mb_batch=MB_BATCH))


def batches(cfg, seeds):
    out = []
    for s in seeds:
        b = make_synthetic_batch(cfg.model, B, seed=s)
        b["video_mask"][1, 2:] = 0            # padded frames too
        b["idx"] = b["idx"] + 100 * s
        out.append(b)
    return out


@pytest.fixture(scope="module")
def trajectories():
    jcfg, tcfg = make_config(jc), make_config(tc)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg.model)
    model = W.from_jax_params(jax.device_get(params), tcfg.model)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    fill = batches(jcfg, range(10, 10 + MB_BATCH))
    steps = batches(jcfg, range(20, 20 + STEPS))
    m = jcfg.model
    cap = jcfg.train.memory_bank_capacity

    jbank = jmb.create(cap, m.max_words, m.max_frames, m.width)
    for i, b in enumerate(fill):
        jbank = jstep.fill_bank_step(params, jbank, jax.tree.map(
            jnp.asarray, b), jcfg, i * B)
    filled = jax.device_get(jbank)
    jstate = jstep.create_train_state(params, jbank)
    jmetrics = []
    for i, b in enumerate(steps):
        jstate, met = jstep.train_step(jstate, jax.tree.map(jnp.asarray, b),
                                       jax.random.PRNGKey(i), jcfg, T_TOTAL)
        jmetrics.append(jax.device_get(met))

    tbank = tmb.create(cap, m.max_words, m.max_frames, m.width)
    for i, b in enumerate(fill):
        tbank = tstep.fill_bank_step(model, tbank, tstep.to_device(b, "cpu"),
                                     tcfg, i * B)
    tfilled = [t.clone() for t in tbank]
    tstate = tstep.create_train_state(model, tbank)
    tmetrics, after_two = [], None
    for i, b in enumerate(steps):
        tstate, met = tstep.train_step(tstate, tstep.to_device(b, "cpu"),
                                       tcfg, T_TOTAL)
        tmetrics.append({k: v.item() for k, v in met.items()})
        if i == 1:
            after_two = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(tcfg=tcfg, init=init, after_two=after_two, filled=filled,
                tfilled=tfilled, jstate=jax.device_get(jstate), tstate=tstate,
                jmetrics=jmetrics, tmetrics=tmetrics, steps=steps)


def test_bank_fill_matches_jax(trajectories):
    for got, want in zip(trajectories["tfilled"], trajectories["filled"]):
        assert torch.isfinite(got.float()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert (trajectories["tfilled"][0] >= 0).all()      # every slot written


def test_losses_match_jax_at_every_step(trajectories):
    for got, want in zip(trajectories["tmetrics"], trajectories["jmetrics"]):
        for k in LOSS_KEYS + ("grad_norm", "logit_scale"):
            assert np.isfinite(got[k]), k
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4,
                                       err_msg=k)


def test_every_parameter_matches_jax_after_three_steps(trajectories):
    t = trajectories
    got = W.to_jax_params(t["tstate"].model.state_dict(), t["tcfg"].model)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(t["jstate"].params)[0]
    assert len(flat_got) == len(flat_want)
    worst = 0.0
    for (pa, a), (pb, b) in zip(flat_got, flat_want):
        assert pa == pb
        assert np.isfinite(a).all(), pa
        err = np.abs(a - np.asarray(b)).max()
        assert err <= 1e-4, (jax.tree_util.keystr(pa), err)
        worst = max(worst, err)
    assert t["tstate"].step == int(t["jstate"].step) == STEPS
    assert t["tstate"].opt.step == int(t["jstate"].opt.step) == STEPS


def test_parameters_move_from_step_two_and_conv1_stays(trajectories):
    """The completed-step schedule zeroes the first update; from the second
    on the trainable tensors move, and the frozen patch embedding never
    does.  Where the loss does not reach a tensor (the `*_fc1` nets and the
    query projection of a block with one key, at one merged token) weight
    decay still moves it, unless it is a bias, which is not decayed: only a
    zero-initialised bias may stand still."""
    t = trajectories
    still = []
    for name, first in t["init"].items():
        second = t["after_two"][name]
        if name == "clip.visual.conv1.weight":
            assert torch.equal(first, second)
            assert torch.equal(first, t["tstate"].model.state_dict()[name])
        elif torch.equal(first, second):
            assert name.endswith("bias") and not first.any(), name
            still.append(name)
    assert len(still) < 10 and not any(n.startswith(("clip.", "transformerClip"))
                                       for n in still), still


def test_bank_after_steps_matches_jax_and_holds_fresh_rows(trajectories):
    t = trajectories
    for got, want in zip(t["tstate"].bank, t["jstate"].bank):
        assert torch.isfinite(got.float()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # FIFO: the newest batch's ids lead, the one before follows
    ids = t["tstate"].bank.ind.numpy()
    np.testing.assert_array_equal(ids[:B], t["steps"][-1]["idx"])
    np.testing.assert_array_equal(ids[B:2 * B], t["steps"][-2]["idx"])


def test_losses_with_cluster_noise_match_jax():
    """With the DPC-KNN tie-break noise on, the port takes the draws as an
    input: fed the draws the JAX package makes from its key, the losses
    agree (1e-4 relative)."""
    jcfg, tcfg = make_config(jc, True), make_config(tc, True)
    params = jm.init_params(jax.random.PRNGKey(1), jcfg.model)
    model = W.from_jax_params(jax.device_get(params), tcfg.model)
    m = jcfg.model
    rng = np.random.default_rng(5)
    cap = jcfg.train.memory_bank_capacity
    rows = (np.arange(cap, dtype=np.int32),
            rng.normal(size=(cap, m.max_words, m.width)).astype(np.float32),
            rng.normal(size=(cap, m.max_frames, m.width)).astype(np.float32),
            np.ones((cap, m.max_words), np.float32),
            np.ones((cap, m.max_frames), np.float32))
    batch = batches(jcfg, [30])[0]
    key = jax.random.PRNGKey(9)
    _, jaux = jstep.compute_losses(
        params, jcfg, jax.tree.map(jnp.asarray, batch),
        jmb.MemoryBank(*map(jnp.asarray, rows)), key)

    # merge_global_features splits the key per modality, merge_to_global
    # per stage; cluster_dpc_knn draws U[0,1) of the density's shape
    def draws(k, n_tokens, sizes):
        k0, k1 = jax.random.split(k)
        return (torch.as_tensor(np.array(jax.random.uniform(
                    k0, (B, n_tokens), jnp.float32))),
                torch.as_tensor(np.array(jax.random.uniform(
                    k1, (B, sizes[0]), jnp.float32))))

    k_t, k_v = jax.random.split(key)
    noise = (draws(k_t, m.max_words, m.text_merge_sizes),
             draws(k_v, m.max_frames, m.video_merge_sizes))
    shapes = tm.draw_cluster_noise(tcfg.model, B, torch.Generator())
    assert [[n.shape for n in pair] for pair in shapes] == \
        [[n.shape for n in pair] for pair in noise]
    with torch.no_grad():
        _, taux = tstep.compute_losses(
            model, tcfg, tstep.to_device(batch, "cpu"),
            tmb.MemoryBank(*map(torch.as_tensor, rows)), noise)
    for k in LOSS_KEYS:
        assert np.isfinite(taux[k].item())
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-4,
                                   err_msg=k)


def test_unported_options_raise():
    cfg = make_config(tc)
    tstep._check_supported(dc.replace(cfg, train=dc.replace(
        cfg.train, micro_batches=2)))           # ported: GradCache, two passes
    tstep._check_supported(dc.replace(cfg, model=dc.replace(
        cfg.model, remat=True, video_chunk_frames=8)))   # ported: checkpoints
    tstep._check_supported(dc.replace(cfg, data=dc.replace(
        cfg.data, augment_backend="device")))    # ported: device RandAugment
    tstep._check_supported(dc.replace(cfg, train=dc.replace(
        cfg.train, explicit_spmd=True)))   # ported: parallel/spmd.py
    tstep._check_supported(dc.replace(cfg, train=dc.replace(
        cfg.train, pipeline_parallel=2)))  # ported: parallel/pipeline.py
    tstep._check_supported(dc.replace(cfg, train=dc.replace(
        cfg.train, fsdp=True)))            # ported: FSDP2, parallel/mesh.py
    # ported: the host placements pass, and a CPU device refuses them where
    # they are placed (both need pinned host memory and a copy stream)
    for section, change in (("train", dict(bank_placement="host")),
                            ("optim", dict(moments_placement="host"))):
        host = dc.replace(cfg, **{section: dc.replace(getattr(cfg, section),
                                                      **change)})
        tstep._check_supported(host)
        model = W.init_model(host.model, 0)
        bank = tmb.create(16, 8, 4, host.model.width)
        with pytest.raises(ValueError, match="needs a TPU/GPU backend"):
            if section == "train":
                tmb.place_bank(bank, host.train.bank_placement, "cpu")
            else:
                tstep.create_train_state(
                    model, bank,
                    moments_placement=host.optim.moments_placement)
    noisy = make_config(tc, True)
    model = W.init_model(noisy.model, 0)
    state = tstep.create_train_state(
        model, tmb.create(16, 8, 4, noisy.model.width))
    with pytest.raises(ValueError, match="Generator"):
        tstep.train_step(state, tstep.to_device(batches(noisy, [1])[0], "cpu"),
                         noisy, T_TOTAL)


def test_similarity_kernels_follows_use_pallas():
    m = make_config(tc).model
    for use_pallas, kernels, want in (("auto", True, True), ("on", True, True),
                                      ("off", True, False),
                                      ("auto", False, False),
                                      ("on", False, False)):
        got = tm.similarity_kernels(dc.replace(m, use_pallas=use_pallas),
                                    kernels)
        assert got is want, (use_pallas, kernels)
    with pytest.raises(ValueError, match="use_pallas"):
        tm.similarity_kernels(dc.replace(m, use_pallas="yes"))


@pytest.mark.parametrize("words,frames", [(8, 4), (64, 32)])
@pytest.mark.parametrize("use_pallas", ["off", "auto"])
def test_use_pallas_off_hands_the_plain_forms_to_every_similarity_call(
        monkeypatch, words, frames, use_pallas):
    """A spy on the model's similarity entry points through one train_step
    on the flagship shape (bank centralities) and on a long-token shape
    (T·V >= 2048: the blocked similarity and the bank matrices).  On the CPU
    every call runs its plain version either way; what is checked is the
    `kernels` each call is handed."""
    import inspect
    calls = []
    for name in ("local_similarity", "bank_centrality"):
        real = getattr(tm, name)
        sig = inspect.signature(real)

        def spy(*a, _real=real, _sig=sig, _name=name, **kw):
            bound = _sig.bind(*a, **kw)
            bound.apply_defaults()
            calls.append((_name, bound.arguments["kernels"]))
            return _real(*a, **kw)
        monkeypatch.setattr(tm, name, spy)

    cfg = make_config(tc)
    m = dc.replace(tc.ModelConfig.tiny(max_words=words, max_frames=frames),
                   cluster_noise=False, use_pallas=use_pallas)
    cfg = dc.replace(cfg, model=m, data=dc.replace(
        cfg.data, max_words=words, max_frames=frames))
    model = W.init_model(m, 0)
    cap = cfg.train.memory_bank_capacity
    rng = np.random.default_rng(3)
    bank = tmb.MemoryBank(
        torch.arange(cap, dtype=torch.int32),
        torch.as_tensor(rng.normal(size=(cap, words, m.width)),
                        dtype=torch.float32),
        torch.as_tensor(rng.normal(size=(cap, frames, m.width)),
                        dtype=torch.float32),
        torch.ones(cap, words), torch.ones(cap, frames))
    state = tstep.create_train_state(model, bank)
    batch = tstep.to_device(make_synthetic_batch(m, B, seed=4), "cpu")
    _, met = tstep.train_step(state, batch, cfg, T_TOTAL)
    assert np.isfinite(met["loss"].item())
    long_tokens = words * frames >= 2048
    bank_calls = ([("local_similarity", True)] * 2 if long_tokens
                  else [("bank_centrality", True)] * 2)
    want = [("local_similarity", long_tokens)] + bank_calls
    if use_pallas == "off":
        want = [(name, False) for name, _ in want]
    assert calls == want


def test_train_step_under_use_pallas_off_matches_jax():
    """Two train steps from the same weights, random bank and batches with
    use_pallas="off" in both packages (the JAX package's XLA forms, the
    port's plain forms): loss terms to 1e-4 relative at each step, every
    parameter tensor to 1e-4 absolute after the second (the schedule's
    first update is zero)."""
    jcfg, tcfg = make_config(jc), make_config(tc)
    jcfg = dc.replace(jcfg, model=dc.replace(jcfg.model, use_pallas="off"))
    tcfg = dc.replace(tcfg, model=dc.replace(tcfg.model, use_pallas="off"))
    params = jm.init_params(jax.random.PRNGKey(2), jcfg.model)
    model = W.from_jax_params(jax.device_get(params), tcfg.model)
    m = jcfg.model
    rng = np.random.default_rng(7)
    cap = jcfg.train.memory_bank_capacity
    rows = (np.arange(cap, dtype=np.int32),
            rng.normal(size=(cap, m.max_words, m.width)).astype(np.float32),
            rng.normal(size=(cap, m.max_frames, m.width)).astype(np.float32),
            np.ones((cap, m.max_words), np.float32),
            np.ones((cap, m.max_frames), np.float32))
    steps = batches(jcfg, [40, 41])
    jstate = jstep.create_train_state(
        params, jmb.MemoryBank(*map(jnp.asarray, rows)))
    tstate = tstep.create_train_state(
        model, tmb.MemoryBank(*(torch.as_tensor(r.copy()) for r in rows)))
    for i, b in enumerate(steps):
        jstate, jmet = jstep.train_step(jstate, jax.tree.map(jnp.asarray, b),
                                        jax.random.PRNGKey(i), jcfg, T_TOTAL)
        tstate, tmet = tstep.train_step(tstate, tstep.to_device(b, "cpu"),
                                        tcfg, T_TOTAL)
        for k in LOSS_KEYS:
            assert np.isfinite(tmet[k].item()), k
            np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                       rtol=1e-4, err_msg=k)
    got = W.to_jax_params(tstate.model.state_dict(), tcfg.model)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jstate.params))[0]
    assert len(flat_got) == len(flat_want)
    for (pa, a), (pb, b) in zip(flat_got, flat_want):
        assert pa == pb
        assert np.isfinite(a).all(), pa
        err = np.abs(a - np.asarray(b)).max()
        assert err <= 1e-4, (jax.tree_util.keystr(pa), err)


@pytest.mark.parametrize("words,frames", [(8, 4), (64, 32)])
def test_sim_dtype_bfloat16_is_refused_on_every_train_path(words, frames):
    """The port refuses sim_dtype="bfloat16" on the flagship and on the
    long-token configuration, in the bank fill and in the step, before any
    work: its similarity kernels and their plain versions multiply in
    float32."""
    cfg = make_config(tc)
    m = dc.replace(tc.ModelConfig.tiny(max_words=words, max_frames=frames),
                   cluster_noise=False, sim_dtype="bfloat16")
    cfg = dc.replace(cfg, model=m, data=dc.replace(
        cfg.data, max_words=words, max_frames=frames))
    model = W.init_model(m, 0)
    bank = tmb.create(cfg.train.memory_bank_capacity, words, frames, m.width)
    batch = tstep.to_device(make_synthetic_batch(m, B, seed=1), "cpu")
    with pytest.raises(NotImplementedError, match="sim_dtype"):
        tstep.fill_bank_step(model, bank, batch, cfg, 0)
    with pytest.raises(NotImplementedError, match="sim_dtype"):
        tstep.train_step(tstep.create_train_state(model, bank), batch, cfg,
                         T_TOTAL)
    with pytest.raises(NotImplementedError, match="sim_dtype"):
        tstep._check_supported(cfg)
