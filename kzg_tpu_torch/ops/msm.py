"""Multi-scalar multiplication (Pippenger) over torch tensors (counterpart of
kzg_tpu/ops/msm.py, its ``chunked`` strategy and ``msm_shifted``).

  * scalars are canonicalized and split into 8-bit windows (byte-aligned with
    the 16-bit limb layout);
  * ``precompute_shifted`` builds the window-shifted bases 2^(8w) P_i once
    per trusted setup with chains of 8 doublings (K3 for G1 on the card), so
    all windows are independent;
  * per window, points are sorted by digit (one packed-key sort and one flat
    gather) and bucket sums come from a two-level segmented scan: a running
    sum along chunks of CL sorted points with all (windows x chunks) as
    lanes — each step is one complete add with a reset mask at digit-run
    starts (K2 for G1 on the card) — then a scan over the chunk tails that
    carries runs across chunk boundaries, a correction of each chunk's
    leading run, and a scatter of segment-end sums into 255 buckets;
  * the bucket-weighted sum  sum_d d*B_d  uses the suffix-sum identity as
    two-level 16x16 scans, and a pairwise tree joins the windows.
"""

from __future__ import annotations

import torch

from ..fields.mont import Field
from ..groups.ec import COORDS, Curve

WINDOW_BITS = 8
BUCKETS = 1 << WINDOW_BITS


def num_windows(r: int) -> int:
    return -(-r.bit_length() // WINDOW_BITS)


def _cat(pts, dim=-1):
    return {k: torch.cat([p[k] for p in pts], dim=dim) for k in COORDS}


def _stack(pts, dim=-1):
    return {k: torch.stack([p[k] for p in pts], dim=dim) for k in COORDS}


def _at(P, i):
    return {k: v[..., i] for k, v in P.items()}


class MSMEngine:
    def __init__(self, group: Curve, fr: Field, order: int):
        self.J = group
        self.fr = fr
        self.W = num_windows(order)
        self.chunk_len = None     # override sqrt(n) chunking

    # ------------------------------------------------------------------
    # scalar digits
    # ------------------------------------------------------------------
    def digits(self, scalars_raw):
        """Canonical raw scalars (L, n) -> (W, n) int64 byte digits."""
        L, n = scalars_raw.shape
        b = torch.stack([scalars_raw & 0xFF, scalars_raw >> 8],
                        dim=1).reshape(2 * L, n)
        return b[: self.W]

    # ------------------------------------------------------------------
    # precomputation: window-shifted bases (2^(8w) * P_i)
    # ------------------------------------------------------------------
    def precompute_shifted(self, P):
        """Point batch (n,) -> point batch (W, n) with row w = 2^(8w) P."""
        J = self.J
        rows = [P]
        S = P
        for _ in range(self.W - 1):
            S = J.dbl_f(S, times=WINDOW_BITS)
            rows.append(S)
        # window axis as a batch axis after the field axes: (..., L, W, n)
        return _stack(rows, dim=-2)

    # ------------------------------------------------------------------
    # core per-window bucket accumulation (batched over windows)
    # ------------------------------------------------------------------
    def _bucket_sums_chunked(self, d_sorted, P_sorted):
        """Two-level segmented scan over the sorted coefficient axis.

        Positions are laid out as (chunks CH, chunk_len CL); a loop runs along
        CL with (W, CH) as lanes, restarting its running sum at digit-run
        starts (one add with reset mask per step). Runs crossing chunk
        boundaries are repaired by a scan over the CH chunk tails plus one
        correction add on the positions of each chunk's carried-in first
        run. Segment-end sums then scatter into their bucket slots."""
        J = self.J
        W, n = d_sorted.shape
        dev = d_sorted.device
        CL = 1
        while CL * CL < n:
            CL *= 2
        if self.chunk_len:
            CL = self.chunk_len
        CH = -(-n // CL)
        npad = CH * CL
        if npad != n:
            pad_ids = torch.full((W, npad - n), BUCKETS, dtype=d_sorted.dtype,
                                 device=dev)
            d_sorted = torch.cat([d_sorted, pad_ids], dim=-1)
            P_sorted = _cat([P_sorted, J.infinity((W, npad - n))])
        prev = torch.cat([torch.full((W, 1), -1, dtype=d_sorted.dtype,
                                     device=dev), d_sorted[:, :-1]], dim=-1)
        seg_start = d_sorted != prev                            # (W, npad)
        nxt = torch.cat([d_sorted[:, 1:], torch.full(
            (W, 1), BUCKETS + 1, dtype=d_sorted.dtype, device=dev)], dim=-1)
        seg_end = d_sorted != nxt

        st = seg_start.reshape(W, CH, CL)
        Pc = {k: v.reshape(v.shape[:-1] + (CH, CL)) for k, v in P_sorted.items()}
        run = J.infinity((W, CH))
        sums = []
        for j in range(CL):
            run = J.add(run, _at(Pc, j), reset=st[..., j])
            sums.append(run)
        tail = run
        # boundary-carry scan over chunk tails: carry_in(c) enters chunk c
        # iff chunk c-1 had no run start (its whole extent continued one run)
        has_start = torch.any(st, dim=-1)                       # (W, CH)
        state = J.infinity((W,))
        cin = []
        for c in range(CH):
            cin.append(state)                  # carry BEFORE the update
            state = J.add(state, _at(tail, c), reset=has_start[:, c])
        carry_in = _stack(cin)                                  # (W, CH)

        # correct each chunk's LEADING run by the carried-in sum — only at its
        # segment-end position, the one slot whose value scatters into a
        # bucket. The leading run ends at fs-1, fs = index of the chunk's
        # first run start (CL if none -> position CL-1, the chunk tail;
        # harmless when that isn't a segment end). fs == 0 means the chunk
        # opens a new run and carries nothing in.
        fs = torch.argmax(st.to(torch.int32), dim=-1)           # 0 if none
        fs = torch.where(has_start, fs, torch.full_like(fs, CL))
        need = fs >= 1
        lead_end = torch.clamp(fs - 1, min=0)                   # (W, CH)
        sums_c = _stack(sums)                                   # (.., W, CH, CL)

        def take_last(leaf):
            ib = lead_end.reshape((1,) * (leaf.ndim - 3) + lead_end.shape
                                  + (1,)).expand(leaf.shape[:-1] + (1,))
            return torch.gather(leaf, -1, ib)[..., 0]

        sel = {k: take_last(v) for k, v in sums_c.items()}
        fixed = J.add(carry_in, sel, reset=torch.logical_not(need))
        onehot = ((torch.arange(CL, device=dev)[None, None, :]
                   == lead_end[..., None]) & need[..., None])   # (W, CH, CL)
        sums = {}
        for k, v in sums_c.items():
            oh = onehot.reshape((1,) * (v.ndim - 3) + onehot.shape)
            sums[k] = torch.where(oh, fixed[k][..., None], v).reshape(
                v.shape[:-2] + (npad,))

        idx = torch.where(seg_end, d_sorted,
                          torch.full_like(d_sorted, BUCKETS))  # (W, npad)
        flat_idx = (torch.arange(W, device=dev)[:, None] * (BUCKETS + 1)
                    + idx).reshape(-1)
        # scatter without accumulate: every bucket has one segment end per
        # window; duplicate writes land only in the discard slot BUCKETS
        inf = J.infinity((W, BUCKETS + 1))
        buckets = {}
        for k in COORDS:
            lead = sums[k].shape[:-2]
            dst = inf[k].reshape(lead + (W * (BUCKETS + 1),)).clone()
            dst[..., flat_idx] = sums[k].reshape(lead + (W * npad,))
            buckets[k] = dst.reshape(lead + (W, BUCKETS + 1))[..., 1:BUCKETS]
        return buckets

    def _bucket_sums(self, digits, Pw):
        """digits (W, n); Pw point batch with batch dims (W, n). Returns point
        batch with batch dims (W, B-1): bucket sums for digits 1..255."""
        W, n = digits.shape
        dev = digits.device
        # (digit, index) packed into one int64 key: a single-array sort, and
        # the index in the low bits makes it stable by construction
        key = (digits << 24) | torch.arange(n, device=dev)[None]
        key_s, _ = torch.sort(key, dim=-1)
        d_sorted = key_s >> 24
        order = key_s & ((1 << 24) - 1)
        flat = (torch.arange(W, device=dev)[:, None] * n + order).reshape(-1)
        P_sorted = {}
        for k in COORDS:
            v = Pw[k]
            lead = v.shape[:-2]
            P_sorted[k] = v.reshape(lead + (W * n,))[..., flat].reshape(
                lead + (W, n))
        return self._bucket_sums_chunked(d_sorted, P_sorted)

    def _tree_reduce(self, P, axis_size):
        """Pairwise-add reduce over the last batch axis (padded w/ infinity)."""
        J = self.J
        m = 1
        while m < axis_size:
            m *= 2
        if m != axis_size:
            lead = J._batch_shape(P["x"])[:-1]
            P = _cat([P, J.infinity(lead + (m - axis_size,))])
        while m > 1:
            half = m // 2
            P = J.add_f({k: v[..., :half] for k, v in P.items()},
                        {k: v[..., half:] for k, v in P.items()})
            m = half
        return _at(P, 0)

    def _weighted_chunked(self, buckets):
        """Weighted total via the suffix identity with two-level (16x16)
        scans. A[i] = bucket for digit i+1 (i = 0..254), padded with one
        identity; FS[j] = sum_{i>=j} A[i]; total = sum_j FS[j]."""
        J = self.J
        lead = J._batch_shape(buckets["x"])[:-1]
        G16 = 16
        A = _cat([buckets, J.infinity(lead + (G16 * G16 - (BUCKETS - 1),))])
        A = {k: v.reshape(v.shape[:-1] + (G16, G16)) for k, v in A.items()}

        # inclusive suffix along lo (from lo=15 down), all hi as lanes
        acc = J.infinity(lead + (G16,))
        suf = [None] * G16
        for lo in range(G16 - 1, -1, -1):
            acc = J.add_f(acc, _at(A, lo))
            suf[lo] = acc
        suf_lo = _stack(suf)                                    # (.., hi, lo)

        # exclusive suffix of group totals along hi
        state = J.infinity(lead)
        ex = [None] * G16
        for hi in range(G16 - 1, -1, -1):
            ex[hi] = state                     # emit BEFORE update
            state = J.add(state, {k: v[..., hi, 0] for k, v in suf_lo.items()})
        S_hi = _stack(ex)                                       # (.., hi)

        # full suffix FS = suf_lo + S_hi (broadcast over lo), then sum all
        S_b = {k: v[..., None].expand(v.shape + (G16,)) for k, v in S_hi.items()}
        FS = J.add_f(suf_lo, S_b)
        acc = J.infinity(lead + (G16,))
        for lo in range(G16):
            acc = J.add_f(acc, _at(FS, lo))
        total = J.infinity(lead)
        for hi in range(G16):
            total = J.add(total, {k: v[..., hi] for k, v in acc.items()})
        return total

    # ------------------------------------------------------------------
    # public MSM entry point
    # ------------------------------------------------------------------
    def msm_shifted(self, scalars_raw, shifted):
        """MSM with precomputed window-shifted bases (batch dims (W, n))."""
        d = self.digits(scalars_raw)                       # (W, n)
        buckets = self._bucket_sums(d, shifted)            # (W, B-1)
        per_window = self._weighted_chunked(buckets)       # (W,)
        return self._tree_reduce(per_window, self.W)       # ()
