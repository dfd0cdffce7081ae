"""Batched feature encoding and the device-resident similarity matrix: the
names the serving path imports, kept here; they live in train/evaluate.py
with the rest of the evaluation harness."""

from .train.evaluate import (encode_text_batch, encode_video_batch,  # noqa: F401
                             similarity_matrix, similarity_matrix_device)
