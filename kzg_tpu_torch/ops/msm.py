"""Multi-scalar multiplication (Pippenger) over torch tensors (counterpart of
kzg_tpu/ops/msm.py: its four bucket strategies, ``msm_shifted`` and
``msm`` over arbitrary bases).

  * scalars are canonicalized and split into 8-bit windows (byte-aligned with
    the 16-bit limb layout);
  * ``precompute_shifted`` builds the window-shifted bases 2^(8w) P_i once
    per trusted setup with chains of 8 doublings (K3/K5 on the card), so
    all windows are independent;
  * per window, points are sorted by digit (one packed-key sort and one flat
    gather) and bucket sums come from one of four strategies:
      - ``chunked`` (the default; the protocol's): a two-level segmented
        scan — a running sum along chunks of CL sorted points with all
        (windows x chunks) as lanes, each step one complete add with a
        reset mask at digit-run starts (K2/K4 on the card), then a scan over
        the chunk tails that carries runs across chunk boundaries, a
        correction of each chunk's leading run, and a scatter of segment-end
        sums into 255 buckets;
      - ``merge``: bottom-up pairwise segment merging, n - 1 adds per window
        in log2(n) levels, each level's combine one K6 launch on the card;
        closed segments scatter straight into their bucket slots;
      - ``log``: a log-depth (Blelloch) segmented scan, ~2n adds;
      - ``scan``: one sequential segmented running sum over all n;
  * the bucket-weighted sum  sum_d d*B_d  uses the suffix-sum identity (as
    two-level 16x16 scans for ``chunked``, a log-depth scan and a pairwise
    tree for ``merge``/``log``, a sequential scan for ``scan``), and windows
    combine by a pairwise tree over window-shifted bases (``msm_shifted``)
    or by a Horner ladder of 8 doublings per window (``msm``, arbitrary
    bases).
"""

from __future__ import annotations

import torch

from ..fields.mont import Field
from ..groups.ec import COORDS, Curve
from . import cuda

WINDOW_BITS = 8
BUCKETS = 1 << WINDOW_BITS
STRATEGIES = ("chunked", "merge", "log", "scan")


def num_windows(r: int) -> int:
    return -(-r.bit_length() // WINDOW_BITS)


def _cat(pts, dim=-1):
    return {k: torch.cat([p[k] for p in pts], dim=dim) for k in COORDS}


def _stack(pts, dim=-1):
    return {k: torch.stack([p[k] for p in pts], dim=dim) for k in COORDS}


def _at(P, i):
    return {k: v[..., i] for k, v in P.items()}


def _tmap(fn, *trees):
    """Map fn over the tensors of equally structured dicts / tuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tmap(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tmap(fn, *[t[i] for t in trees])
                        for i in range(len(t0)))
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def scan_last(combine, elems, make_identity):
    """Inclusive associative scan along the *last* axis of every tensor of a
    dict / tuple tree (field tensors are limb-major, the scanned batch axis
    last). combine(a, b) must be associative; make_identity(k) returns a
    tree whose tensors have last-axis length k (odd-length padding only).
    ~2n combine applications, log-depth (Blelloch-style recursion)."""
    n = _first_leaf(elems).shape[-1]
    if n == 1:
        return elems
    if n % 2:
        elems = _tmap(lambda v, p: torch.cat([v, p], dim=-1), elems,
                      make_identity(1))
    even = _tmap(lambda v: v[..., 0::2], elems)
    odd = _tmap(lambda v: v[..., 1::2], elems)
    z = combine(even, odd)                       # pair sums, length m
    s = scan_last(combine, z, make_identity)     # s_k = x_0 ... x_{2k+1}
    sprev = _tmap(lambda v: v[..., :-1], s)
    even_tail = _tmap(lambda v: v[..., 1:], even)
    eo = combine(sprev, even_tail)               # outputs at 2, 4, ...
    even_out = _tmap(lambda h, t: torch.cat([h[..., :1], t], dim=-1),
                     even, eo)
    out = _tmap(lambda a, b: torch.stack([a, b], dim=-1).reshape(
        a.shape[:-1] + (2 * a.shape[-1],)), even_out, s)
    return _tmap(lambda v: v[..., :n], out)


class MSMEngine:
    def __init__(self, group: Curve, fr: Field, order: int,
                 strategy: str = "chunked"):
        """strategy: 'chunked' (default, the protocol's), 'merge', 'log' or
        'scan' — see the module docstring."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown MSM strategy {strategy!r} "
                             f"(one of {STRATEGIES})")
        self.J = group
        self.fr = fr
        self.W = num_windows(order)
        self.strategy = strategy
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
    def _scatter_set(self, buckets, idx, pts):
        """Write point batch `pts` (batch (W, m)) into `buckets` (batch
        (W, BUCKETS+1)) at per-lane bucket index idx (W, m); index BUCKETS
        is the discard slot. Indices must be unique per window (except
        discards). Updates `buckets` in place (its tensors are the caller's
        own) and returns it."""
        W, m = idx.shape
        flat_idx = (torch.arange(W, device=idx.device)[:, None]
                    * (BUCKETS + 1) + idx).reshape(-1)
        for k in COORDS:
            dst = buckets[k]
            lead = dst.shape[:-2]
            dst.view(lead + (W * (BUCKETS + 1),))[..., flat_idx] = \
                pts[k].reshape(lead + (W * m,))
        return buckets

    def _combine(self, aL, aR, bL, bR, fuse, asing, bsing):
        """One merge level's combine (T5): mid = aR + bL; newL = (asing &
        fuse) ? mid : aL; newR = (bsing & fuse) ? mid : bR. One K6 launch
        on the card."""
        if self.J._kernel_device(aL):
            return cuda.merge_combine(self.J, aL, aR, bL, bR, fuse, asing,
                                      bsing)
        return self._combine_plain(aL, aR, bL, bR, fuse, asing, bsing)

    def _combine_plain(self, aL, aR, bL, bR, fuse, asing, bsing):
        """Plain version of K6: the plain complete add and two selects."""
        J = self.J
        mid = J._add_plain(aR, bL)
        newL = J.select(torch.logical_and(asing, fuse), mid, aL)
        newR = J.select(torch.logical_and(bsing, fuse), mid, bR)
        return mid, newL, newR

    def _bucket_sums_merge(self, d_sorted, P_sorted):
        """Bottom-up pairwise segmented reduction: n-1 complete adds per
        window, each level one combine (K6 on the card); closed segments
        scatter straight into their bucket slots (unique writes).

        Every node covers a range of sorted positions and carries the ids
        and sums of its leftmost and rightmost digit runs (one run: single).
        Merging A and B fuses A's right run with B's left run when their
        digits agree; a run that can grow no more is emitted."""
        J = self.J
        W, n = d_sorted.shape
        dev = d_sorted.device
        m = 1
        while m < n:
            m *= 2
        if m != n:                       # pad with discard-id infinity items
            pad_ids = torch.full((W, m - n), BUCKETS, dtype=d_sorted.dtype,
                                 device=dev)
            d_sorted = torch.cat([d_sorted, pad_ids], dim=-1)
            P_sorted = _cat([P_sorted, J.infinity((W, m - n))])
        idL = idR = d_sorted
        sumL = sumR = P_sorted
        single = torch.ones((W, m), dtype=torch.bool, device=dev)
        buckets = J.infinity((W, BUCKETS + 1))

        def half(P, j):
            return {k: v[..., j::2] for k, v in P.items()}

        while m > 1:
            A_idL, B_idL = idL[:, 0::2], idL[:, 1::2]
            A_idR, B_idR = idR[:, 0::2], idR[:, 1::2]
            A_s, B_s = single[:, 0::2], single[:, 1::2]
            AL, BL, AR, BR = half(sumL, 0), half(sumL, 1), half(sumR, 0), \
                half(sumR, 1)
            fuse = A_idR == B_idL
            mid, newL, newR = self._combine(AL, AR, BL, BR, fuse, A_s, B_s)
            nf = torch.logical_not(fuse)
            nA, nB = torch.logical_not(A_s), torch.logical_not(B_s)
            emitA = torch.logical_and(nf, nA)            # A.sumR closes
            emitB = torch.logical_and(nf, nB)            # B.sumL closes
            emitM = torch.logical_and(fuse, torch.logical_and(nA, nB))
            for mask, ids, pts in ((emitA, A_idR, AR), (emitB, B_idL, BL),
                                   (emitM, A_idR, mid)):
                idx = torch.where(mask, ids, BUCKETS)
                buckets = self._scatter_set(buckets, idx, pts)
            idL, idR = A_idL, B_idR
            single = torch.logical_and(torch.logical_and(A_s, B_s), fuse)
            sumL, sumR = newL, newR
            m //= 2
        # root: leftmost segment always open; rightmost too unless single
        buckets = self._scatter_set(buckets, idL, sumL)
        idx2 = torch.where(single, BUCKETS, idR)
        buckets = self._scatter_set(buckets, idx2, sumR)
        return {k: v[..., 1:BUCKETS] for k, v in buckets.items()}

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
        if self.strategy == "chunked":
            return self._bucket_sums_chunked(d_sorted, P_sorted)
        if self.strategy == "merge":
            return self._bucket_sums_merge(d_sorted, P_sorted)

        J = self.J
        prev = torch.cat([torch.full((W, 1), -1, dtype=d_sorted.dtype,
                                     device=dev), d_sorted[:, :-1]], dim=-1)
        seg_start = d_sorted != prev                            # (W, n)
        nxt = torch.cat([d_sorted[:, 1:], torch.full(
            (W, 1), BUCKETS, dtype=d_sorted.dtype, device=dev)], dim=-1)
        seg_end = d_sorted != nxt
        if self.strategy == "log":
            # segmented monoid (run-start flag, sum): select(fb, xb, xa + xb)
            # is the add with reset mask fb (K2/K4 on the card)
            def combine(a, b):
                fa, xa = a
                fb, xb = b
                return (torch.logical_or(fa, fb), J.add(xa, xb, reset=fb))

            def make_identity(k):
                return (torch.zeros((W, k), dtype=torch.bool, device=dev),
                        J.infinity((W, k)))

            _, sums = scan_last(combine, (seg_start, P_sorted),
                                make_identity)
        else:
            # sequential segmented running sum over the coefficient axis:
            # select(st, Pi, add(carry, Pi)) is one add with reset mask
            run = J.infinity((W,))
            rows = []
            for j in range(n):
                run = J.add(run, _at(P_sorted, j), reset=seg_start[:, j])
                rows.append(run)
            sums = _stack(rows)

        # scatter segment-end sums into (W, B+1) buckets (slot B = discard)
        idx = torch.where(seg_end, d_sorted, BUCKETS)            # (W, n)
        buckets = self._scatter_set(J.infinity((W, BUCKETS + 1)), idx, sums)
        return {k: v[..., 1:BUCKETS] for k, v in buckets.items()}

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

    def _weighted_bucket_total(self, buckets):
        """sum_b (b+1) * buckets[..., b] over the last axis (b = 0..B-2
        representing digits 1..255), via the suffix-sum identity
        sum_d d*B_d = sum_t (sum_{d>=t} B_d)."""
        if self.strategy == "chunked":
            return self._weighted_chunked(buckets)
        J = self.J
        lead = J._batch_shape(buckets["x"])[:-1]
        if self.strategy in ("log", "merge"):
            rev = {k: v.flip(-1) for k, v in buckets.items()}
            suffix = scan_last(J.add_f, rev,
                               lambda k: J.infinity(lead + (k,)))
            return self._tree_reduce(suffix, BUCKETS - 1)
        suf = J.infinity(lead)
        tot = J.infinity(lead)
        for b in range(BUCKETS - 2, -1, -1):
            suf = J.add(suf, _at(buckets, b))
            tot = J.add(tot, suf)
        return tot

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
        per_window = self._weighted_bucket_total(buckets)  # (W,)
        return self._tree_reduce(per_window, self.W)       # ()

    def msm(self, scalars_raw, P):
        """MSM over arbitrary bases (batch (n,)) — Horner over windows, from
        the most significant down; the 8 doublings of a step are one
        dbl_f(acc, 8) (one K3/K5 launch on the card)."""
        J = self.J
        d = self.digits(scalars_raw)                       # (W, n)
        Pw = {k: v[..., None, :].expand(v.shape[:-1] + (self.W, v.shape[-1]))
              for k, v in P.items()}
        buckets = self._bucket_sums(d, Pw)
        per_window = self._weighted_bucket_total(buckets)  # batch (W,)
        acc = J.infinity(())
        for w in range(self.W - 1, -1, -1):
            acc = J.add(J.dbl_f(acc, WINDOW_BITS), _at(per_window, w))
        return acc
