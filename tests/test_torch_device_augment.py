"""The port's device RandAugment (ops/device_augment.py) against the JAX
package's, and the train step and trainer under `--augment_backend device`.

The draws come from the JAX `sample_policy` (or are written out), go to both
packages as numpy arrays, and the port takes them through
`apply_randaugment_draws`.  Clips are structured uint8 (gradients, a flat
patch, stripes, noise in a band) of 4 frames x 32 x 48: random noise would
leave AutoContrast and Equalize inert, and a non-square frame catches an
H/W mix-up.

The JAX functions run eagerly, op by op, as they are written: under `jit`
XLA would fuse multiplies into adds and turn divisions by constants into
multiplications, rounding otherwise than the code says.  Bounds: the LUT,
threshold, linear, blend and equalize ops are the same fp32 arithmetic in
both and byte-equal.  The warps are the same arithmetic too, but their maps
pass through cos/sin and a 3x3 product whose last bit may differ between
the two libraries: a tap position that moves by an ulp across a pixel
boundary changes the bilinear blend by at most one level, so warped pixels
are held to |Δ| <= 1 on at most 0.5%.
"""

import dataclasses as dc
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborretr_tpu.ops import device_augment as JDA
from neighborretr_tpu_torch.core import checkpoint as tckpt
from neighborretr_tpu_torch.core import config as tc
from neighborretr_tpu_torch.data.datasets.synthetic import SyntheticDataset
from neighborretr_tpu_torch.models import weights_io as W
from neighborretr_tpu_torch.ops import device_augment as DA
from neighborretr_tpu_torch.train import loop as tloop
from neighborretr_tpu_torch.train import memory_bank as tmb
from neighborretr_tpu_torch.train import step as tstep

GEOMETRIC = {"ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"}
WARP_SHARE = 0.005          # of the pixels that may differ, by one level


def structured_clips(seed, B, F=4, H=32, W=48):
    """[B, F, H, W, 3] uint8: per clip a colour ramp in [lo, hi] at a random
    angle, a flat patch, a band of stripes (sharp edges), noise in the left
    quarter; frames shifted by one column each."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = np.empty((B, F, H, W, 3), np.uint8)
    for b in range(B):
        lo, hi = rng.integers(20, 80), rng.integers(160, 236)
        t = np.cos(rng.uniform(0, 2 * np.pi)) * xx / W + \
            np.sin(rng.uniform(0, 2 * np.pi)) * yy / H
        t = (t - t.min()) / np.ptp(t)
        img = np.stack([lo + (hi - lo) * t, lo + (hi - lo) * t[::-1],
                        lo + (hi - lo) * (1 - t)], axis=-1)
        r, c = rng.integers(0, H // 2), rng.integers(0, W // 2)
        img[r:r + H // 3, c:c + W // 3] = rng.integers(lo, hi, size=3)
        img[:, 2 * W // 3:] = np.where((yy[:, 2 * W // 3:, None] % 8) < 4,
                                       hi, lo)
        for f in range(F):
            fr = np.roll(img, f, axis=1)
            fr[:, :W // 4] += rng.normal(0, 12, (H, W // 4, 3))
            out[b, f] = np.clip(np.rint(fr), 0, 255)
    return out


def port(video, draws, policy):
    return DA.apply_randaugment_draws(
        torch.as_tensor(video), *(torch.as_tensor(np.array(a)) for a in draws),
        policy).numpy()


def assert_warp_close(got, want, what=""):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = (d > 0).mean()
    assert d.max() <= 1 and share <= WARP_SHARE, (what, d.max(), share)


# ---------------------------------------------------------------------------
# one layer, each op: against JAX's _layer
# ---------------------------------------------------------------------------

LEVELS = [(3.0, False), (3.0, True), (7.0, False), (7.0, True),
          (10.0, False), (10.0, True)]


@pytest.mark.parametrize("name", DA.OP_NAMES)
def test_each_op_matches_the_jax_layer(name):
    """One layer with every clip firing `name` at (level, sign) pairs; a
    seventh clip does not fire (the identity)."""
    B = len(LEVELS) + 1
    video = structured_clips(1, B)
    op = np.full((B, 1), DA.OP_NAMES.index(name), np.int32)
    fire = np.ones((B, 1), bool)
    fire[-1] = False
    level = np.array([[lv] for lv, _ in LEVELS] + [[7.0]], np.float32)
    neg = np.array([[ng] for _, ng in LEVELS] + [[False]], bool)
    want = np.asarray(JDA._layer(
        jnp.asarray(video), *(jnp.asarray(a[:, 0]) for a in (op, fire, level,
                                                             neg)),
        JDA.DeviceAugmentPolicy()))
    got = port(video, (op, fire, level, neg), DA.DeviceAugmentPolicy())
    assert got.dtype == np.uint8 and got.shape == video.shape
    np.testing.assert_array_equal(got[-1], video[-1])
    if name in GEOMETRIC:
        assert_warp_close(got, want, name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)
    if name != "Identity":
        assert (got[:-1] != video[:-1]).any(), f"{name} changed nothing"


# ---------------------------------------------------------------------------
# whole policies: against JAX's apply_randaugment on its own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["rand-m7-n4-mstd0.5-inc1",
                                    "rand-m9-n2-mstd0.5-inc1"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_whole_policy_matches_jax(policy, seed):
    video = structured_clips(10 + seed, 8)
    key = jax.random.PRNGKey(seed)
    pol = JDA.DeviceAugmentPolicy.parse(policy)
    want = np.asarray(JDA.apply_randaugment(jnp.asarray(video), key, pol))
    draws = [np.asarray(a) for a in JDA.sample_policy(key, 8, pol)]
    got = port(video, draws, policy)
    assert_warp_close(got, want, policy)
    assert (got != video).any()


def test_affine_maps_match_jax():
    """Every layer's map and their composition, within 1e-6."""
    key = jax.random.PRNGKey(4)
    pol = JDA.DeviceAugmentPolicy(prob=0.9)
    draws = [np.array(a) for a in JDA.sample_policy(key, 64, pol)]
    jm = np.stack([np.asarray(JDA._affine_matrices(
        *(jnp.asarray(a[:, i]) for a in draws), 32, 48))
        for i in range(pol.num_layers)], axis=1)
    tm = torch.stack([DA._affine_matrices(
        *(torch.as_tensor(a[:, i]) for a in draws), 32, 48)
        for i in range(pol.num_layers)], dim=1)
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        DA.compose_affine(tm).numpy(),
        np.asarray(JDA.compose_affine(jnp.asarray(jm))), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the op table and the parser
# ---------------------------------------------------------------------------

def test_op_table_is_the_jax_one():
    assert DA.OP_NAMES == JDA.OP_NAMES


@pytest.mark.parametrize("config", [
    "rand-m7-n4-mstd0.5-inc1", "rand-m9-n2-mstd1.0-inc1", "rand-m5-n3-p0.7",
    "rand-m7-w0.5", "augmix-m3", "rand-m7-nX"])
def test_parser_is_the_jax_one(config):
    try:
        want = dc.asdict(JDA.DeviceAugmentPolicy.parse(config))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("'")[0]):
            DA.DeviceAugmentPolicy.parse(config)
        return
    assert dc.asdict(DA.DeviceAugmentPolicy.parse(config)) == want


# ---------------------------------------------------------------------------
# frames, padding, dtype, the slot cap
# ---------------------------------------------------------------------------

def test_prob_zero_is_the_exact_identity():
    video = torch.as_tensor(structured_clips(2, 3))
    gen = torch.Generator().manual_seed(0)
    out = DA.apply_randaugment(video, gen, DA.DeviceAugmentPolicy(prob=0.0))
    assert torch.equal(out, video)


def test_frames_of_a_clip_share_the_draws():
    same = np.repeat(structured_clips(3, 6)[:, :1], 4, axis=1)
    out = DA.apply_randaugment(torch.as_tensor(same),
                               torch.Generator().manual_seed(11),
                               "rand-m7-n4-mstd0.5-inc1")
    for f in range(1, 4):
        assert torch.equal(out[:, f], out[:, 0])
    assert not torch.equal(out, torch.as_tensor(same))


def test_padding_frames_stay_zero_and_draws_are_seeded():
    video = structured_clips(4, 4)
    video[:, 2:] = 0
    mask = torch.zeros(4, 4)
    mask[:, :2] = 1
    v = torch.as_tensor(video)
    for seed in range(6):
        out = DA.augment_batch(v, mask, torch.Generator().manual_seed(seed),
                               "rand-m7-n4-mstd0.5-inc1")
        assert out.dtype == torch.uint8 and out[:, 2:].max() == 0
        again = DA.augment_batch(v, mask, torch.Generator().manual_seed(seed),
                                 "rand-m7-n4-mstd0.5-inc1")
        assert torch.equal(out, again)


def test_float_frames_raise():
    with pytest.raises(TypeError, match="uint8"):
        DA.apply_randaugment(torch.zeros(1, 2, 8, 8, 3),
                             torch.Generator().manual_seed(0),
                             "rand-m7-n4-mstd0.5-inc1")


def test_no_slot_cap_every_clip_gets_its_ops():
    """B = 48 with p = 0.9: far more clips draw each costly op than the
    JAX module's max(8, ⌈B/6⌉) slots; each clip's result is that of the
    clip augmented alone with its own draws."""
    B = 48
    video = structured_clips(5, B)
    pol = DA.DeviceAugmentPolicy(prob=0.9)
    draws = [a.numpy() for a in DA.sample_policy(
        torch.Generator().manual_seed(3), B, pol)]
    eq = (draws[1] & (draws[0] == DA.OP_NAMES.index("Equalize"))).any(1)
    assert eq.sum() > 8
    got = port(video, draws, pol)
    for b in range(B):
        alone = port(video[b:b + 1], [a[b:b + 1] for a in draws], pol)
        np.testing.assert_array_equal(got[b:b + 1], alone, err_msg=str(b))


# ---------------------------------------------------------------------------
# the train step and the trainer under augment_backend="device"
# ---------------------------------------------------------------------------

B_, T_TOTAL = 8, 10


def tiny_config(backend="device", **train):
    return tc.Config(
        model=dc.replace(tc.ModelConfig.tiny(max_words=8, max_frames=4),
                         cluster_noise=False),
        loss=tc.LossConfig(num_neighbors=3),
        optim=tc.OptimizerConfig(lr=1e-2, coef_lr=0.1),
        data=tc.DataConfig(max_words=8, max_frames=4, augment_backend=backend,
                           workers=0),
        train=tc.TrainConfig(batch_size=B_, mb_batch=1, **train))


def tiny_batch(cfg):
    ds = SyntheticDataset(n=B_, max_words=8, max_frames=4, resolution=32,
                          vocab_size=cfg.model.clip.vocab_size, seed=3)
    items = [ds.item(i) for i in range(B_)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    batch["video"][:, :, :, :16] = structured_clips(6, B_, H=32, W=16)
    batch["video_mask"][1, 2:] = 0
    batch["video"][1, 2:] = 0
    return tstep.to_device(batch, "cpu")


@pytest.fixture(scope="module")
def step_runs():
    """One step from the same weights and bank: device backend twice with
    the same generator seed, host backend on the port's own augment of the
    same draws, host backend on the raw batch."""
    cfg = tiny_config()
    model = W.init_model(cfg.model, 0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = tiny_batch(cfg)

    def step(cfg, batch, gen):
        model.load_state_dict(start)
        state = tstep.create_train_state(model, tmb.create(
            cfg.train.memory_bank_capacity, 8, 4, cfg.model.width))
        _, met = tstep.train_step(state, batch, cfg, T_TOTAL,
                                  augment_generator=gen)
        return {k: v.item() for k, v in met.items()}, {
            k: v.clone() for k, v in model.state_dict().items()}

    def gen():
        return torch.Generator().manual_seed(7)

    host = tiny_config("auto")
    augmented = dict(batch, video=DA.augment_batch(
        batch["video"], batch["video_mask"], gen(), cfg.data.augment))
    return dict(a=step(cfg, batch, gen()), b=step(cfg, batch, gen()),
                host_aug=step(host, augmented, None),
                raw=step(host, batch, None), batch=batch, augmented=augmented)


def test_device_backend_step_is_deterministic(step_runs):
    (ma, pa), (mb, pb) = step_runs["a"], step_runs["b"]
    assert all(np.isfinite(v) for v in ma.values())
    assert ma == mb
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_device_backend_step_is_the_host_step_on_augmented_pixels(step_runs):
    (ma, pa), (mh, ph) = step_runs["a"], step_runs["host_aug"]
    assert ma == mh
    for k in pa:
        assert torch.equal(pa[k], ph[k]), k
    assert step_runs["augmented"]["video"][1, 2:].max() == 0


def test_device_backend_step_differs_from_no_augment(step_runs):
    assert not torch.equal(step_runs["augmented"]["video"],
                           step_runs["batch"]["video"])
    assert step_runs["a"][0]["loss"] != step_runs["raw"][0]["loss"]


def test_device_backend_needs_a_generator_and_uint8():
    cfg = tiny_config()
    model = W.init_model(cfg.model, 0)
    state = tstep.create_train_state(model, tmb.create(
        cfg.train.memory_bank_capacity, 8, 4, cfg.model.width))
    batch = tiny_batch(cfg)
    with pytest.raises(ValueError, match="Generator"):
        tstep.train_step(state, batch, cfg, T_TOTAL)
    with pytest.raises(TypeError, match="uint8"):
        tstep.train_step(state, dict(batch, video=batch["video"].float()),
                         cfg, T_TOTAL,
                         augment_generator=torch.Generator().manual_seed(0))


def test_fill_bank_step_with_a_generator_augments():
    cfg = tiny_config()
    model = W.init_model(cfg.model, 0)
    batch = tiny_batch(cfg)

    def fill(gen):
        bank = tmb.create(cfg.train.memory_bank_capacity, 8, 4,
                          cfg.model.width)
        return tstep.fill_bank_step(model, bank, batch, cfg, 0, True, gen)

    plain = fill(None)
    seeded = fill(torch.Generator().manual_seed(2))
    again = fill(torch.Generator().manual_seed(2))
    assert not torch.equal(plain.feat_v, seeded.feat_v)
    assert torch.equal(seeded.feat_v, again.feat_v)


def test_augment_generators_depend_on_their_position_only():
    def draw(*pos):
        return torch.rand(4, generator=tloop.augment_generator("cpu", *pos))

    assert torch.equal(draw(3, 7), draw(3, 7))
    assert not torch.equal(draw(3, 7), draw(3, 8))
    assert not torch.equal(draw(3, 0, 7), draw(3, 7))      # fill vs step
    assert not torch.equal(
        draw(3, 7), torch.rand(4, generator=tloop.step_generator(3, 7, "cpu")))


def test_device_backend_mid_epoch_resume_is_exact(tmp_path, monkeypatch):
    """Interrupted after step 3 of 4 and resumed: the same loss at step 4
    and bit-equal parameters and bank as the uninterrupted run."""
    kw = dict(n=16, max_words=8, max_frames=4, resolution=32, vocab_size=512)
    data = SyntheticDataset(**kw), SyntheticDataset(seed=1, **kw)

    def config(out, resume=None):
        return tiny_config(epochs=2, batch_size_val=8, n_display=1,
                           output_dir=str(out), resume_checkpoint=resume,
                           mid_epoch_eval=False, seed=0)

    ref, _ = tloop.run_training(config(tmp_path / "ref"), *data,
                                device="cpu")
    assert ref.step == 4
    real, calls = tloop.train_step, {"n": 0}

    def stepper(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        if calls["n"] == 3:
            signal.raise_signal(signal.SIGTERM)
        return out

    monkeypatch.setattr(tloop, "train_step", stepper)
    cut, _ = tloop.run_training(config(tmp_path / "cut"), *data, device="cpu")
    assert cut.step == 3
    monkeypatch.setattr(tloop, "train_step", real)
    path = tckpt.latest_resumable(str(tmp_path / "cut"))
    resumed, _ = tloop.run_training(config(tmp_path / "cut", path), *data,
                                    device="cpu")
    assert resumed.step == 4
    for (name, a), b in zip(ref.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(ref.bank, resumed.bank):
        assert torch.equal(a, b)
