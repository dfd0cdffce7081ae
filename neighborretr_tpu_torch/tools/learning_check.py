"""Does the trainer learn?  The port's counterpart of
tests/test_convergence.py's memorisation case: from random init, tiny
towers memorise 16 caption/video pairs in 120 optimizer steps through
`train.loop.run_training` (the bank fill and every step through the device
prefetch), and R@1 over the 16 pairs must reach 75 in both directions
(chance is 6.25).

    python3 -m neighborretr_tpu_torch.tools.learning_check [--device cuda] \
        [--bank_placement host] [--opt_moments_placement host]

As in the JAX test, the centrality and neighbour losses are on and the
uniform and KL terms off (at random init they pull every pair into one
plateau), at lr 5e-3 with the CLIP branch at the same rate.  Batch 8 over
16 pairs is 2 steps an epoch, so 120 steps are 60 epochs, each with its
bank fill and an eval of the 16 pairs; R@1 is read from the eval after the
last step.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

PAIRS, BATCH, STEPS, WORDS, FRAMES = 16, 8, 120, 8, 4
R1_BAR = 75.0


def config(output_dir: str, bank_placement: str = "device",
           moments_placement: str = "device"):
    from ..core.config import (Config, DataConfig, LossConfig, ModelConfig,
                               OptimizerConfig, TrainConfig)
    return Config(
        model=ModelConfig.tiny(max_words=WORDS, max_frames=FRAMES),
        loss=LossConfig(num_neighbors=3, uniform_weight=0.0, kl_weight=0.0),
        optim=OptimizerConfig(lr=5e-3, coef_lr=1.0, warmup_proportion=0.02,
                              moments_placement=moments_placement),
        data=DataConfig(max_words=WORDS, max_frames=FRAMES, workers=0),
        train=TrainConfig(epochs=STEPS * BATCH // PAIRS, batch_size=BATCH,
                          batch_size_val=BATCH, mb_batch=2, n_display=50,
                          output_dir=output_dir, save_checkpoints=False,
                          mid_epoch_eval=False, seed=0,
                          bank_placement=bank_placement))


def run(device: str = "cuda", bank_placement: str = "device",
        moments_placement: str = "device") -> dict:
    """Trains and evaluates → {"t2v_r1", "v2t_r1", "steps", "seconds",
    "state"}: R@1 of the eval after the last step, the steps taken, the
    run's wall time (host clock) and its final TrainState."""
    import logging

    from ..data.datasets.synthetic import SyntheticDataset
    from ..data.loader import BatchLoader
    from ..train.evaluate import evaluate
    from ..train.loop import run_training

    with tempfile.TemporaryDirectory() as out:
        cfg = config(out, bank_placement, moments_placement)
        m = cfg.model
        data = SyntheticDataset(n=PAIRS, max_words=WORDS, max_frames=FRAMES,
                                resolution=m.clip.image_resolution,
                                vocab_size=m.clip.vocab_size, seed=0)
        logger = logging.getLogger("neighborretr_tpu_torch.learning_check")
        logger.setLevel(logging.WARNING)
        t0 = time.perf_counter()
        state, _ = run_training(cfg, data, data, logger=logger,
                                device=device)
        loader = BatchLoader(data, BATCH, workers=0, pad_to_batch=True)
        t2v, v2t = evaluate(state.model, cfg, loader, dataset=data,
                            logger=logger)
        return {"t2v_r1": float(t2v["R1"]), "v2t_r1": float(v2t["R1"]),
                "steps": state.step, "seconds": time.perf_counter() - t0,
                "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bank_placement", default="device",
                    choices=["device", "host"])
    ap.add_argument("--opt_moments_placement", default="device",
                    choices=["device", "host"])
    args = ap.parse_args(argv)
    got = run(args.device, args.bank_placement, args.opt_moments_placement)
    got.pop("state")
    print(json.dumps(got))
    ok = min(got["t2v_r1"], got["v2t_r1"]) >= R1_BAR
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
