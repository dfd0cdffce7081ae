"""The checks that follow the program past its towers: the training step's
bank centralities from given features and bank, and a search request's
scores from the text features it was served from."""

import numpy as np
import pytest
import torch

from benchmark.harness import compare, core, port
from benchmark.kinds import search
from benchmark.reference import model as R
from benchmark.reference import search as RS
from benchmark.reference import train as RT
from benchmark.tests.tiny import tiny_files


def _params(cell, seed=7):
    from neighborretr_tpu_torch.models.neighborretr import NeighborRetr
    files = tiny_files(cell)
    cfg = port.program_config(files)
    shapes = port.shapes(NeighborRetr(cfg.model, device="meta"))
    return files, port.reference_weights(shapes, seed, "cpu")


def test_centrality_stage_is_the_losses_centralities():
    """The stage's float64 centralities are the bank means the reference's
    own loss takes, and the gap reads inf where the program's were not
    observed or cover other rows."""
    _, P = _params("vitb32.msrvtt_train")
    g = torch.Generator().manual_seed(3)
    B, W, F, E, N = 6, 12, 4, 64, 18
    t, v = torch.randn(B, W, E, generator=g), torch.randn(B, F, E, generator=g)
    tm = (torch.arange(W)[None] < torch.tensor([[4], [12], [7], [5], [9],
                                                [3]])).float()
    vm = (torch.arange(F)[None] < torch.tensor([[2], [4], [3], [4], [1],
                                                [4]])).float()
    bank = {"feat_t": torch.randn(N, W, E, generator=g),
            "feat_v": torch.randn(N, F, E, generator=g),
            "mask_t": torch.ones(N, W), "mask_v": torch.ones(N, F)}
    want_t = R.local_similarity(P, t, bank["feat_v"], tm, bank["mask_v"]
                                ).mean(dim=1)
    want_v = R.local_similarity(P, bank["feat_t"], v, bank["mask_t"], vm
                                ).mean(dim=0)
    got_t, got_v = RT.centrality_stage(P, t, v, tm, vm, bank)
    assert got_t.dtype == torch.float64
    assert torch.allclose(got_t.float(), want_t, atol=1e-6)
    assert torch.allclose(got_v.float(), want_v, atol=1e-6)
    ref = {1: got_t, 0: got_v}
    assert compare.centrality_gap({1: want_t, 0: want_v}, ref) < 1e-6
    assert compare.centrality_gap({1: want_t}, ref) == float("inf")
    assert compare.centrality_gap({1: want_t[:3], 0: want_v}, ref) == \
        float("inf")


def test_pair_scores_are_the_search_scores():
    _, P = _params("vitb32.search")
    g = torch.Generator().manual_seed(4)
    t = torch.randn(2, 10, 64, generator=g)
    tm = torch.ones(2, 10)
    tm[1, 6:] = 0
    v = torch.randn(9, 4, 64, generator=g)
    vm = torch.ones(9, 4)
    vm[3, 2:] = 0
    S = RS.scores(P, t, tm, v, vm)
    for i in range(2):
        rows = torch.tensor([3, 0, 8])
        got = RS.pair_scores(P, t[i], tm[i], v[rows], vm[rows])
        assert got.dtype == torch.float64
        assert torch.allclose(got.float(), S[i, rows], atol=1e-6)


def test_served_features_come_from_the_call_that_served_the_request():
    """A request is matched to the tower call between its submit and reply
    whose token ids hold its query; other calls of the same query and calls
    outside its time are not taken."""
    from benchmark.reference.tokenizer import Tokenizer
    tok = Tokenizer()
    queries = ["a man sings", "a dog runs"]
    ids = [torch.as_tensor(tok.caption(q, 8)[0]) for q in queries]
    pad = torch.zeros(8, dtype=torch.long)

    def call(t, rows, mark):
        out = torch.full((len(rows), 8, 4), float(mark))
        return (t, torch.stack(rows), out)

    encoded = [call(1.0, [ids[0], pad], 1), call(2.0, [pad, ids[0]], 2),
               call(2.5, [ids[1], pad], 3), call(9.0, [ids[0]], 4)]
    judged = [(1.5, 3.0, None, 0), (2.2, 2.8, None, 1), (5.0, 6.0, None, 1)]
    got = search.served_features(judged, queries, encoded, 8)
    assert float(got[0][0, 0]) == 2.0 and float(got[1][0, 0]) == 3.0
    assert got[2] is None


def test_search_stage_fails_where_a_request_was_not_observed():
    files, P = _params("vitb32.search")
    t = files["traffic"]
    feat, mask = core.generator(files).make_index(t, 64, 7, "cpu")
    gap = search._sim_gap(P, None, [None], ["a man"], np.zeros((1, 2), int),
                          np.zeros((1, 2), np.float32), feat.float(), mask,
                          t["max_words"])
    assert gap == float("inf")
