"""Probe of the bf16 wide flash kernels (head dims above 256) on one H100.

    python3 flash_wide_probe.py

Builds patched copies of ``csrc/flash_attention_wide.cu`` (one ``nvcc``
each, all at once) and reads the device time of each wide kernel under each
beside the shipped library, in turns (shipped, variants, variants reversed,
shipped), at octo_deep_h512's three stages (B=32, 3 heads of 512, dropout
0.1 in the training kernels; the forward without LSE at B=1 and 8 at its
first stage) and at head dim 768 (B=8, one head):

    dkv_unshared  dk/dv with one warp a row group of 16 keys and 64-column
                  slices (kDkvDS = 1): S^T and dP^T recomputed for every
                  64 columns of D, no pass through shared memory (the
                  first design)
    dv64          forward and dq slices of 64 columns in place of 128 (half
                  the output registers, twice the recomputed logits)
    chunk32       the forward's and dk/dv's reduction chunks of 32 columns
                  in place of 64 (half the ring's shared memory, twice its
                  barriers)
    dq_chunk64    dq's reduction chunks of 64 columns in place of 32 (one
                  block an SM in place of two, half the barriers)

Each computes the same function and is held against the plain version
(bf16, in units of eps * (1 + |plain|)) and recorded.  Writes every reading
to ``chiprun_out/flash_wide_probe.json`` and prints it as the last line.
Needs the card and ``nvcc``; the shipped kernels are held by
``chip_smoke.py``.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs
from flash_fwd_probe import run

# name -> [(text of csrc/flash_attention_wide.cu, its replacement)], each
# text found exactly once
PATCHES = {
    "dkv_unshared": [("constexpr int kDkvDS = 2;",
                      "constexpr int kDkvDS = 1;")],
    "dv64": [("constexpr int kFwdDV = 128;", "constexpr int kFwdDV = 64;")],
    "chunk32": [("constexpr int kDC = 64;", "constexpr int kDC = 32;")],
    "dq_chunk64": [("constexpr int kDqDC = 32;",
                    "constexpr int kDqDC = 64;")],
}
SAME_FUNCTION = tuple(PATCHES)
# name -> (batch, layout strings, stage, heads, head_dim)
SHAPES = {**{f"deep_h512_S{s}": (32, cs.DEEP_SPEC, stage, 3, 512)
             for stage, s in enumerate((224, 160, 96))},
          "d768_S224": (8, cs.DEEP_SPEC, 0, 1, 768)}


def cases(fa):
    """name -> (kernel, variants, call, plain) at the shapes above."""
    out = {}
    seed = torch.tensor([5, 6], dtype=torch.int64, device="cuda")
    for name, (b, strings, stage, h, d) in SHAPES.items():
        mask = cs.stage_mask(strings, stage)
        _, (q, k, v, do), (padded, k_hi, q_lo), tiles = cs.flash_case(
            fa, mask, b, h, d, torch.bfloat16, seed=9)
        kw = dict(block_q=tiles[0], block_k=tiles[1],
                  dropout_rate=cs.TRAIN_DROPOUT)
        fwd_args = (q, k, v, padded, k_hi, seed)
        o, lse = fa.flash_fwd_lse(*fwd_args, **kw)
        delta = fa.attention_delta(do, o, padded.shape[0])
        dq_args = (q, k, v, do, lse, delta, padded, k_hi, seed)
        dkv_args = (q, k, v, do, lse, delta, padded, q_lo, seed)
        out[f"flash_fwd_lse {name}"] = (
            "flash_fwd_lse_wide_kernel", ["dv64", "chunk32"],
            lambda a=fwd_args, kw=kw: fa.flash_fwd_lse(*a, **kw)[0],
            lambda a=fwd_args, kw=kw: fa.flash_fwd_lse_wide_reference(
                *a, **kw)[0])
        out[f"flash_dq {name}"] = (
            "flash_dq_wide_kernel", ["dv64", "dq_chunk64"],
            lambda a=dq_args, kw=kw: fa.flash_dq(*a, **kw),
            lambda a=dq_args, kw=kw: fa.flash_dq_wide_reference(*a, **kw))
        out[f"flash_dkv {name}"] = (
            "flash_dkv_wide_kernel", ["dkv_unshared", "chunk32"],
            lambda a=dkv_args, kw=kw: torch.stack(fa.flash_dkv(*a, **kw)),
            lambda a=dkv_args, kw=kw: torch.stack(
                fa.flash_dkv_wide_reference(*a, **kw)))
    for b in (1, 8):
        args, kw = cs.fwd_case(fa, cs.stage_mask(cs.DEEP_SPEC, 0), b, 3, 512,
                               torch.bfloat16, seed=13)
        out[f"flash_fwd deep_h512_S224_B{b}"] = (
            "flash_fwd_wide_kernel", ["dv64", "chunk32"],
            lambda a=args, kw=kw: fa.flash_fwd(*a, **kw),
            lambda a=args, kw=kw: fa.flash_fwd_wide_reference(*a, **kw))
    return out


def main():
    return run(PATCHES, cases, SAME_FUNCTION, "flash_wide_probe.json",
               library="flash_attention_wide")


if __name__ == "__main__":
    sys.exit(main())
