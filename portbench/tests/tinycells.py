"""The benchmark's cells shrunk to sizes a test run can hold: the same
code paths at small widths, few frames, few clips, few DDIM steps."""

from __future__ import annotations

import copy

from portbench import harness


def tiny(name: str, head_dim: int = 16, frames: int = 60) -> harness.Cell:
    """``frames`` of 128 or more send the decoder's attention to the
    kernels on the card (their gate: both sequence axes at least 128)."""
    cell = harness.Cell.named(name, harness.with_held(harness.benchmark()))
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["denoiser"].update(latent_dim=2 * head_dim, ff_size=64, num_layers=2, num_heads=2,
                                   max_seq_length=frames, cond_encoder_layers=1)
    if "guide" in cell.config:
        cell.config["guide"].update(latent_dim=32, ff_size=64, num_layers=2, num_heads=2, tokens=64)
        cell.config["vq"].update(emb_width=16, code_dim=64)
    tr = cell.traffic
    if tr["kind"] == "train":
        tr.update(batch=4, frames=frames, min_frames=frames * 3 // 4, reference_block_rows=2,
                  person={"train_scenes": 2, "held_out_scenes": 6, "frames_per_scene": frames + frames // 4})
    else:
        tr.update(clips=2, frames=frames, respacing="ddim10", checked_steps=3)
    return cell


def f32(cell: harness.Cell) -> harness.Cell:
    """``cell`` at the f32 point (the reference's), to hold the two to rounding."""
    cell.traffic["point"]["denoiser"].update(dtype="float32", frontend_dtype="float32")
    return cell
