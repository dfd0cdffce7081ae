"""The port's CLIs on the four file-based datasets (MSR-VTT, MSVD, DiDeMo,
ActivityNet), on the CPU at smoke size: real encoded clips written with
cv2, the annotation layouts of the reference's loaders, the native C++
host augment on.

MSR-VTT: train, then index and search (from the npz and from a reference
`.pth` exported from it); two runs give identical losses; pack_dataset
packs what the JAX package's packs and training from the pack gives the
decoding run's losses; a tiny OpenAI-layout `--clip_checkpoint` archive
starts the towers.  MSVD: the multi-sentence eval.  DiDeMo and
ActivityNet: paragraphs.  The port's loader batches are bit-equal to the
JAX package's on the same files and seed, host augment on and off: the
port's `data/` copy is held to the JAX package's here.
"""

import csv
import json
import os
import pickle

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from e2e_common import write_clip  # noqa: E402
from neighborretr_tpu.data.loader import BatchLoader as JBatchLoader  # noqa: E402
from neighborretr_tpu.data.registry import build_dataset as jbuild  # noqa: E402
from neighborretr_tpu.data.tokenizer import ClipTokenizer as JTokenizer  # noqa: E402
from neighborretr_tpu_torch.cli import eval as eval_cli  # noqa: E402
from neighborretr_tpu_torch.cli import export_checkpoint as export_cli  # noqa: E402
from neighborretr_tpu_torch.cli import index as index_cli  # noqa: E402
from neighborretr_tpu_torch.cli import pack_dataset as pack_cli  # noqa: E402
from neighborretr_tpu_torch.cli import search as search_cli  # noqa: E402
from neighborretr_tpu_torch.cli import train as train_cli  # noqa: E402
from neighborretr_tpu_torch.data.loader import BatchLoader  # noqa: E402
from neighborretr_tpu_torch.data.packed import PackedReader, clip_key  # noqa: E402
from neighborretr_tpu_torch.data.registry import build_dataset  # noqa: E402
from neighborretr_tpu_torch.data.tokenizer import ClipTokenizer  # noqa: E402

WORDS, FRAMES, RES = 12, 4, 32
TRAIN_FLAGS = ["--device", "cpu", "--tiny", "--epochs", "1",
               "--batch_size", "8", "--batch_size_val", "4",
               "--max_words", str(WORDS), "--max_frames", str(FRAMES),
               "--mb_batch", "1", "--n_display", "1", "--num_neighbors", "3",
               "--workers", "0", "--augment_backend", "native",
               "--mid_epoch_eval", "0"]
LOSSES = ("loss", "centrality_loss", "neighbor_loss", "uniform_loss",
          "kl_loss", "grad_norm")


def _clip(path, seed):
    write_clip(path, seed, n_frames=10, fps=5)


def _msrvtt(root):
    videos, anno = root / "videos", root / "anns"
    videos.mkdir(), anno.mkdir()
    for i in range(12):
        _clip(videos / f"video{i}.mp4", seed=i)
    with open(anno / "MSRVTT_train.9k.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["video_id"])
        w.writeheader()
        for i in range(8):
            w.writerow({"video_id": f"video{i}"})
    sentences = []
    for i in range(8):
        sentences += [{"video_id": f"video{i}",
                       "caption": f"a person does activity {i}"},
                      {"video_id": f"video{i}",
                       "caption": f"someone performs action number {i}"}]
    json.dump({"sentences": sentences}, open(anno / "MSRVTT_data.json", "w"))
    with open(anno / "MSRVTT_JSFUSION_test.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["video_id", "sentence"])
        w.writeheader()
        for i in range(8, 12):
            w.writerow({"video_id": f"video{i}",
                        "sentence": f"a clip showing scene {i}"})


def _msvd(root):
    videos, anno = root / "videos", root / "anns"
    videos.mkdir(), anno.mkdir()
    train = [f"train{i}" for i in range(8)]
    test = ["testA", "testB", "testC"]
    for i, vid in enumerate(train + test):
        _clip(videos / f"{vid}.mp4", seed=20 + i)
    (anno / "train_list.txt").write_text("\n".join(train) + "\n")
    (anno / "val_list.txt").write_text("testA\n")
    (anno / "test_list.txt").write_text("\n".join(test) + "\n")
    captions = {v: [["someone", "does", "thing", str(i)],
                    ["a", "person", "acts", str(i)]]
                for i, v in enumerate(train)}
    # uneven caption counts per test video: the multi-sentence protocol
    captions["testA"] = [["a", "red", "scene"], ["the", "red", "clip"]]
    captions["testB"] = [["a", "green", "scene"], ["the", "green", "clip"],
                         ["green", "pixels", "move"]]
    captions["testC"] = [["a", "blue", "scene"]]
    pickle.dump(captions, open(anno / "raw-captions.pkl", "wb"))


def _didemo(root):
    videos, anno = root / "videos", root / "anns"
    videos.mkdir(), anno.mkdir()
    train = [f"clip{i}" for i in range(8)]
    test = [f"tclip{i}" for i in range(4)]
    for i, vid in enumerate(train + test):
        _clip(videos / f"{vid}.mp4", seed=40 + i)
    (anno / "train_list.txt").write_text("\n".join(train) + "\n")
    (anno / "test_list.txt").write_text("\n".join(test) + "\n")
    json.dump([{"video": v, "description": f"moment {j} of {v}."}
               for v in train for j in range(2)],
              open(anno / "train_data.json", "w"))
    json.dump([{"video": v, "description": f"test moment {j} of {v}."}
               for v in test for j in range(2)],
              open(anno / "test_data.json", "w"))


def _activitynet(root):
    videos, anno = root / "videos", root / "anns"
    videos.mkdir(), anno.mkdir()
    train = [f"v_tr{i}" for i in range(8)]
    test = [f"v_te{i}" for i in range(4)]
    for i, vid in enumerate(train + test):
        # stripped and v_-prefixed file names both resolve
        _clip(videos / f"{vid[2:] if i % 2 == 0 else vid}.mp4", seed=60 + i)
    json.dump(train, open(anno / "train_ids.json", "w"))
    json.dump(test, open(anno / "val_ids.json", "w"))
    json.dump({v: {"duration": 9.5, "sentences":
                   [f"part one of {v}.", f"part two of {v}."]}
               for v in train}, open(anno / "train.json", "w"))
    json.dump({v: {"duration": 7.0, "sentences": [f"a scene in {v}."]}
               for v in test}, open(anno / "val_1.json", "w"))


LAYOUTS = {"msrvtt": _msrvtt, "msvd": _msvd, "didemo": _didemo,
           "activitynet": _activitynet}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for name, write in LAYOUTS.items():
        root = tmp_path_factory.mktemp(name)
        write(root)
        out[name] = (str(root / "anns"), str(root / "videos"), root)
    return out


def data_flags(trees, name):
    anno, videos, _ = trees[name]
    return ["--datatype", name, "--anno_path", anno, "--video_path", videos]


def train(trees, name, out, *extra):
    """The port's train CLI in this process → (train rows, eval rows)."""
    train_cli.main(TRAIN_FLAGS + data_flags(trees, name)
                   + ["--output_dir", str(out), *extra])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    return ([r for r in rows if r["kind"] == "train"],
            [r for r in rows if r["kind"] == "eval"])


def check_run(out, rows, evals, n_steps):
    assert [r["step"] for r in rows] == list(range(1, n_steps + 1))
    assert all(np.isfinite(r[k]) for r in rows for k in LOSSES)
    assert len(evals) == 1 and all(
        np.isfinite(e[d][k]) for e in evals for d in ("t2v", "v2t")
        for k in ("R1", "R5", "R10", "MR"))
    log = open(os.path.join(out, "log.txt")).read()
    assert "memory bank filled" in log
    # best.npz and the final test exist where the eval found a hit
    hit = evals[0]["t2v"]["R1"] + evals[0]["v2t"]["R1"] > 0
    assert os.path.exists(os.path.join(out, "best.npz")) == hit
    assert ("Final test on best checkpoint" in log) == hit
    assert os.path.exists(os.path.join(out, "state_epoch0.npz"))


@pytest.fixture(scope="module")
def msrvtt_run(trees):
    out = trees["msrvtt"][2] / "run"
    rows, evals = train(trees, "msrvtt", out)
    return out, rows, evals


def test_msrvtt_train_index_and_search(trees, msrvtt_run, capsys):
    out, rows, evals = msrvtt_run
    # 16 train pairs (8 videos x 2 captions) at batch 8: two steps
    check_run(out, rows, evals, 2)
    weights = str(out / "state_epoch0.npz")
    index = str(out / "corpus.npz")
    common = ["--device", "cpu", "--tiny", "--max_words", str(WORDS)]
    index_cli.main(data_flags(trees, "msrvtt") + common + [
        "--checkpoint", weights, "--max_frames", str(FRAMES),
        "--batch_size", "4", "--workers", "0", "--out", index])
    with np.load(index) as idx:
        assert sorted(map(str, idx["video_ids"])) == sorted(
            f"video{i}" for i in range(8, 12))
        assert np.isfinite(idx["v_feat"].astype(np.float32)).all()
    query = ["--index", index, "--topk", "2", "--query",
             "a clip showing scene 9"]
    capsys.readouterr()
    search_cli.main(common + query + ["--checkpoint", weights])
    hits = capsys.readouterr().out
    assert hits.count("video") == 2, hits
    # the same weights as a reference checkpoint answer the same
    pth = str(out / "best.pth")
    export_cli.main(common + ["--checkpoint", weights, "--max_frames",
                              str(FRAMES), "--out", pth])
    capsys.readouterr()
    search_cli.main(common + query + ["--checkpoint", pth])
    assert capsys.readouterr().out == hits


def test_msrvtt_training_is_deterministic(trees, msrvtt_run):
    """The same command twice gives the same losses: cv2 decode, the native
    augment's per-item generators and the step add no nondeterminism."""
    _, rows, _ = msrvtt_run
    again, _ = train(trees, "msrvtt", trees["msrvtt"][2] / "again")
    assert len(again) == len(rows) == 2
    for a, b in zip(rows, again):
        for k in LOSSES:
            assert a[k] == b[k], (k, a, b)


def test_pack_dataset_matches_jax_and_trains(trees, msrvtt_run, capsys):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from cli.pack_dataset import main as jax_pack

    anno, videos, root = trees["msrvtt"]
    packs = {}
    for tag, pack in (("jax", jax_pack), ("port", pack_cli.main)):
        packs[tag] = str(root / f"packed_{tag}")
        capsys.readouterr()
        assert pack(["--datatype", "msrvtt", "--anno_path", anno,
                     "--video_path", videos, "--output_dir", packs[tag],
                     "--max_frames", str(FRAMES), "--resolution", str(RES),
                     "--workers", "2"]) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["packed_clips"] == 12 and summary["empty_clips"] == 0
    jr, pr = PackedReader(packs["jax"]), PackedReader(packs["port"])
    assert len(jr) == len(pr) == 12 and pr.clips == jr.clips
    assert pr.meta == jr.meta
    for i in range(12):
        key = clip_key(f"video{i}")
        (jf, jm), (pf, pm) = jr.get(key), pr.get(key)
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(pm, jm)
    # training from the pack reads the frames the decoding run decoded
    _, rows, _ = msrvtt_run
    packed, evals = train(trees, "msrvtt", root / "from_pack",
                          "--packed_dir", packs["port"])
    assert evals
    for a, b in zip(rows, packed):
        for k in LOSSES:
            assert a[k] == b[k], (k, a, b)


def test_msvd_multi_sentence_eval(trees):
    out = trees["msvd"][2] / "run"
    rows, evals = train(trees, "msvd", out)
    check_run(out, rows, evals, 2)
    # the eval CLI on the epoch's weights gives the epoch's evaluation: 6
    # caption queries over 3 videos
    t2v, v2t = eval_cli.main(data_flags(trees, "msvd") + [
        "--device", "cpu", "--tiny", "--checkpoint",
        str(out / "state_epoch0.npz"), "--max_words", str(WORDS),
        "--max_frames", str(FRAMES), "--batch_size_val", "4",
        "--workers", "0"])
    for got, want in ((t2v, evals[0]["t2v"]), (v2t, evals[0]["v2t"])):
        for k in ("R1", "R5", "R10", "MR"):
            assert float(got[k]) == pytest.approx(want[k], abs=1e-6), k


@pytest.mark.parametrize("name", ["didemo", "activitynet"])
def test_paragraph_datasets_train(trees, name):
    out = trees[name][2] / "run"
    rows, evals = train(trees, name, out)
    check_run(out, rows, evals, 1)      # 8 paragraphs at batch 8


def _first_batches(loader, n=2):
    it = iter(loader)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("augment", ["native", "off"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_loader_batches_equal_jax(trees, name, augment):
    anno, videos, _ = trees[name]
    kw = dict(max_words=WORDS, max_frames=FRAMES, resolution=RES,
              is_train=True, seed=5,
              augment="rand-m7-n4-mstd0.5-inc1" if augment != "off" else None,
              augment_backend="native" if augment != "off" else "auto")
    jds = jbuild(name, "train", anno, videos, JTokenizer(), **kw)
    pds = build_dataset(name, "train", anno, videos, ClipTokenizer(), **kw)
    assert jds.pairs == pds.pairs
    loaders = [cls(ds, 4, shuffle=True, drop_last=True, workers=2, seed=11)
               for cls, ds in ((JBatchLoader, jds), (BatchLoader, pds))]
    for loader in loaders:
        loader.set_epoch(1)
    want, got = (_first_batches(loader) for loader in loaders)
    for wb, gb in zip(want, got):
        assert sorted(gb) == sorted(wb)
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
    if augment != "off":        # the augment moved the pixels
        plain = build_dataset(name, "train", anno, videos, ClipTokenizer(),
                              **dict(kw, augment=None))
        loader = BatchLoader(plain, 4, shuffle=True, drop_last=True,
                             workers=2, seed=11)
        loader.set_epoch(1)
        raw = _first_batches(loader)
        assert not all(np.array_equal(a["video"], b["video"])
                       for a, b in zip(raw, got))


def test_train_from_openai_clip_archive(trees, tmp_path):
    """A tiny OpenAI-layout TorchScript archive (fp16) as --clip_checkpoint:
    the towers start from it and the run trains."""
    import dataclasses as dc

    from neighborretr_tpu_torch.core.config import ClipConfig
    from neighborretr_tpu_torch.tools import clip_archive as CA
    # --tiny on file-based data keeps the full BPE vocabulary
    c = dc.replace(ClipConfig.tiny(), vocab_size=ClipConfig().vocab_size)
    archive = str(tmp_path / "tiny_clip.pt")
    CA.save_openai_archive(CA.random_openai_state_dict(c, seed=7), c, archive)
    seen = {}
    real = train_cli.__dict__.get("_run")

    def spy(args):
        from neighborretr_tpu_torch.train import loop
        start = loop.train_step

        def first(state, *a, **kw):
            seen.setdefault("clip", {k: v.clone() for k, v in
                                     state.model.clip.state_dict().items()})
            return start(state, *a, **kw)
        loop.train_step = first
        try:
            return real(args)
        finally:
            loop.train_step = start

    train_cli._run = spy
    try:
        out = tmp_path / "run"
        rows, evals = train(trees, "msrvtt", out, "--clip_checkpoint",
                            archive)
    finally:
        train_cli._run = real
    check_run(out, rows, evals, 2)
    assert "Loaded CLIP weights from" in open(out / "log.txt").read()
    want = CA.random_openai_state_dict(c, seed=7)
    for k, v in want.items():
        np.testing.assert_array_equal(
            seen["clip"][k].numpy(),
            np.asarray(v, np.float16).astype(np.float32), err_msg=k)
