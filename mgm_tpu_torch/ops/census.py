"""Census transform as bit-packed int32 words (counterpart of
mgm_tpu/ops/census.py).

The reference packs per-pixel `center < neighbour` bits into bytes and
re-interprets groups of 4 bytes as floats (census_tools.cc:38-99); the
census *distance* is then the Hamming distance of the packed words
divided by the number of words (mgm_costvolume.h:65-78).  Bits are
packed in the (channel, dy, dx) enumeration order into ceil(nbits/32)
32-bit words, as the JAX module packs its uint32 words; the port keeps
them as int32 (the type K1 and K8 read), bit for bit the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def census_words(nch: int, winradius: int) -> int:
    side = 2 * winradius + 1
    nbits = nch * (side * side - 1)
    return (nbits + 31) // 32


def census_transform(img: torch.Tensor, winradius: int) -> torch.Tensor:
    """(H, W, C) float32 -> (H, W, nwords) int32 census codes.

    Out-of-image neighbours compare as NaN, and `a < NaN` is false
    (census_tools.cc:29-53), so those bits are 0.  Every bit comes from
    one comparison of a stack of the window's shifted views (a few
    large tensor ops, where a loop over the bits would launch hundreds
    of small ones on the card)."""
    H, W, C = img.shape
    r = winradius
    nwords = census_words(C, r)
    chw = img.permute(2, 0, 1)
    padded = F.pad(chw, (r, r, r, r), value=float("nan"))
    offs = [(j, i) for j in range(-r, r + 1) for i in range(-r, r + 1)
            if (i, j) != (0, 0)]
    # bit k = (channel, dy, dx) in enumeration order: neighbour (y+j, x+i)
    nb = torch.stack([padded[:, r + j:r + j + H, r + i:r + i + W]
                      for j, i in offs], 1)                # (C, K, H, W)
    bits = (chw[:, None] < nb).reshape(C * len(offs), H, W).to(torch.int64)
    bits = F.pad(bits, (0, 0, 0, 0, 0, nwords * 32 - bits.shape[0]))
    place = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=img.device),
        torch.arange(32, device=img.device))
    # int64 sums hold the 32 bits of a word without a sign
    w = (bits.reshape(nwords, 32, H, W) * place[:, None, None]).sum(1)
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
    return w.permute(1, 2, 0).contiguous()
