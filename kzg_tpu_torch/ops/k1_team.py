"""The lane-team layout of K1 (csrc/mont_mul.cu, mont_mul_team_kernel), as
data, and a plain PyTorch model of the team's rounds.

Below ops/cuda.py's K1_TEAM_BELOW lanes, K1 gives each lane of a batch to
a team of T threads (*ranks*) inside one warp. The lane's 2 L product
columns (L limbs of 16 bits, R = 2^(16 L)) are split into contiguous
ranges of C = ceil(2 L / T) columns, rank r owning [r C, r C + C) (ranks
past 2 L own none). The ranks run in lockstep, so a step of the product or
of a round costs the widest rank's C columns whatever the terms in them:
ranges are balanced by column count. Each rank then

  product  accumulates its columns, sum over x of a_x b_(k - x), into
           64-bit registers (L steps over x of a sliding window of b);
  rounds   i = 0 .. L - 1 in order: the rank that owns column i takes m_i
           = (t_i mod 2^16) n0 mod 2^16 and its carry c_i = (t_i + m_i p_0)
           >> 16. Where it owns column i + 1 too, it adds m_i p_1 + c_i
           there at once, so its chain of rounds waits on no other
           thread, and broadcasts m_i, which every rank adds as m_i p_(k -
           i) into each other column k it owns one round later (a column's
           turn comes at least one round after); at the end of its range
           it broadcasts (c_i << 16) | m_i in one 64-bit word, every rank
           adds m_i p at once and the owner of column i + 1 adds c_i;
  high     normalizes its columns of L .. 2 L - 1 to 16-bit digits; one
           to three passes move each rank's carry into the next rank's
           digits until every carry is 0 or 1 (one pass where a rank holds
           3 or more); a carry-lookahead over the ranks' generate (carry
           1) and propagate (digits all 0xFFFF) bits gives each its carry
           in; the carry out of column 2 L - 1 is dropped (mod R, as
           Field._mul_plain does).

The output is limb for limb Field._mul_plain's: both take m_i from the
fully carried column i, so both add the same m p to a b.

``run_d32`` models the other product of the lane executor, mont.cuh's
mont_mul_d32 (K6's at 25 limbs, ops/team.py MERGE_DIGITS): the same
Montgomery product on D = (L + 1) / 2 digits of 32 bits, its rows and
rounds interleaved, D - 1 rounds of 32 bits with n1 = -p^-1 mod 2^32 and a
last round of 16 bits, so R = 2^(16 L) as before. The Montgomery factor
of (a b + M p) / R is the one M in [0, R) with a b + M p = 0 mod R,
whatever digit size the rounds take, so its output too is limb for limb
Field._mul_plain's.

``table(L, layout)`` is the uint32 array that the wrapper passes to the C
entry point: threads per team T, warps per block W, C, then the (start,
end) column range of each rank. The kernel's registers are laid out at
compile time for its T, so the entry point refuses a table whose ranges
are not this even split. ``run`` executes the same table on the CPU with
torch integer ops; the CPU tests hold it against Field._mul_plain and the
JAX package's Field.mul.
"""

from __future__ import annotations

import functools

import torch

LIMB_MASK = 0xFFFF
TEAMS = (4, 8, 16, 32)             # the team sizes the kernel is built for
MAX_WARPS = 8
# (threads per team, warps per block) per limb count, from team_sweep.py
# k1 on the H100 (PERF.md, runs Z5 and Z6): teams of 16 are within 6% of
# teams of 32 at 216 lanes and ahead from 1024 lanes up, and 0.55-0.94 x the
# thread-per-lane time below the width rule at 25 limbs, 0.72-0.93 x at 17,
# 0.94-0.98 x at 11
LAYOUT = {17: (16, 4), 25: (16, 4), 11: (16, 4)}


def columns(L, team):
    """C: the product columns each rank owns (the last ranks fewer or
    none)."""
    return -(-2 * L // team)


def table(L, layout=None):
    """The K1 team table at L limbs: [T, W, C, start_0, end_0, ...,
    start_(T-1), end_(T-1)]."""
    team, warps = layout or LAYOUT[L]
    if team not in TEAMS or not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"K1 team layout {(team, warps)}: team in {TEAMS}, "
                         f"1 <= warps <= {MAX_WARPS}")
    C = columns(L, team)
    words = [team, warps, C]
    for r in range(team):
        words += [min(r * C, 2 * L), min(r * C + C, 2 * L)]
    return words


def lanes_per_block(tab):
    return (32 // tab[0]) * tab[1]


def _ranges(tab):
    return [(tab[3 + 2 * r], tab[4 + 2 * r]) for r in range(tab[0])]


def _owner(ranges, k):
    """(rank, slot) of column k."""
    for r, (s, e) in enumerate(ranges):
        if s <= k < e:
            return r, k - s
    raise ValueError(f"column {k} has no owner")


@functools.lru_cache(maxsize=None)
def _window_index(ranges, C, shift, L):
    """(T, C) rows of v to gather for _window: k - shift for each rank's
    slot columns k, L (a zero row) where k - shift is not in [0, L) or the
    slot is past the rank's range."""
    return torch.tensor([[s + q - shift if s + q < e and 0 <= s + q - shift
                          < L else L for q in range(C)] for s, e in ranges])


def _window(v, ranges, C, shift, L):
    """(T, C, *batch) of v[k - shift] for each rank's slot columns k, zero
    where k - shift is not in [0, L): v is (L, *batch)."""
    vz = torch.cat([v, torch.zeros_like(v[:1])])
    return vz[_window_index(tuple(ranges), C, shift, L).to(v.device)]


def _lagged(lagged, win):
    """m_(i - 1) p under every rank's columns but the one its owner took
    at once (win: the window of round i - 1)."""
    m, o, s = lagged
    add = m * win
    add[o, s] = 0
    return add


def high(t, ranges, C, L):
    """The kernel's high half: (T, C, *batch) columns after the rounds ->
    the L 16-bit digits of columns L .. 2 L - 1 (list of tensors). Each
    rank normalizes its own; NP passes carry each rank's carry into the
    next rank's digits; then the carry-lookahead of the generate and
    propagate bits gives each rank its carry in; the carry out of column
    2 L - 1 is dropped."""
    T = len(ranges)
    hi = [[q for q in range(e - s) if L <= s + q < 2 * L] for s, e in ranges]
    t = t.clone()

    def absorb(r, cin):
        for q in hi[r]:
            v = t[r, q] + cin
            t[r, q] = v & LIMB_MASK
            cin = v >> 16
        return cin

    zero = torch.zeros_like(t[0, 0])
    carry = [absorb(r, zero) for r in range(T)]
    for _ in range(1 if C >= 3 else 2 if C == 2 else 3):
        carry = [absorb(r, carry[r - 1] if r else zero) for r in range(T)]
    g = sum((c != 0).to(torch.int64) << r for r, c in enumerate(carry))
    ones = [torch.ones_like(zero, dtype=torch.bool)] * T
    for r in range(T):
        for q in hi[r]:
            ones[r] = ones[r] & (t[r, q] == LIMB_MASK)
    pr = sum(o.to(torch.int64) << r for r, o in enumerate(ones))
    x = g | pr
    cins = ((x + g) ^ x ^ g)
    for r in range(T):
        absorb(r, (cins >> r) & 1)
    return [t[r, q] for r, (s, e) in enumerate(ranges) for q in range(e - s)
            if L <= s + q < 2 * L]


def run(F, a, b, tab=None, stats=None):
    """K1's team rounds under table `tab` (default: the shipped layout at
    F's limb count) on (L, *batch) int64 limbs: the kernel's product,
    rounds and high-half carries rank by rank. Returns (L, *batch) exact
    16-bit limbs. `stats`, if given, gets the largest column and the
    largest broadcast carry."""
    L = F.L
    tab = list(table(L) if tab is None else tab)
    ranges = _ranges(tab)
    C = tab[2]
    if [min(r * C, 2 * L) for r in range(tab[0])] != [s for s, _ in ranges]:
        raise ValueError("K1 team table: ranges are not the even split")
    a, b = F._bc(a, b)
    p = F.p_limbs.reshape((L,) + (1,) * (a.ndim - 1)).expand(a.shape)
    # product: slot q of rank r accumulates column k = start_r + q
    t = torch.zeros((len(ranges), C) + a.shape[1:], dtype=torch.int64,
                    device=a.device)
    for x in range(L):
        t += a[x] * _window(b, ranges, C, x, L)
    # rounds: column i's owner takes (m_i, c_i). Within its range it adds
    # m_i p_1 + c_i to its column i + 1 at once and broadcasts m_i, which
    # every rank adds (times p) into its other columns in the next round;
    # at the end of its range it broadcasts (c_i << 16) | m_i, and every
    # rank adds m_i p at once, the next owner c_i too
    big = 0
    lagged = None                           # (m, owner, slot) of round i - 1
    for i in range(L):
        o, s = _owner(ranges, i)
        o1, s1 = _owner(ranges, i + 1)
        ti = t[o, s]
        m = ((ti & LIMB_MASK) * F.n0) & LIMB_MASK
        c = (ti + m * F.p_list[0]) >> 16
        big = max(big, int(c.max()) if c.numel() else 0)
        if lagged is not None:
            t += _lagged(lagged, _window(p, ranges, C, i - 1, L))
        if o1 == o:
            t[o, s1] += m * F.p_list[1] + c
            lagged = (m, o, s1)
        else:
            word = (c << 16) | m                # the kernel's 64-bit word
            m, c = word & LIMB_MASK, word >> 16
            t += m * _window(p, ranges, C, i, L)
            t[o1, s1] += c
            lagged = None
    if lagged is not None:
        t += _lagged(lagged, _window(p, ranges, C, L - 1, L))
    digits = high(t, ranges, C, L)
    if stats is not None:
        stats["column"] = max(stats.get("column", 0),
                              int(t.max()) if t.numel() else 0)
        stats["carry"] = max(stats.get("carry", 0), big)
    return torch.stack(digits)


# ----------------------------------------------------------------------
# the digit product (mont.cuh mont_mul_d32)
# ----------------------------------------------------------------------

WORD = 0xFFFFFFFF


def n1(F):
    """-p^-1 mod 2^32: the digit product's Montgomery factor (F.n0 is its
    low 16 bits)."""
    return F.params.pprime & WORD


def _digits(x, L):
    """(L, *batch) lazy limbs -> (D, *batch) exact 32-bit digits, as the
    kernel's to_digits packs them (the top digit takes limb L - 1 and the
    carry)."""
    out, c = [], torch.zeros_like(x[0])
    for j in range(L // 2):
        c = c + x[2 * j] + (x[2 * j + 1] << 16)
        out.append(c & WORD)
        c = c >> 32
    out.append((x[L - 1] + c) & WORD)
    return torch.stack(out)


def _mul_wide(x, y):
    """The low and high words of x y (both below 2^32): mul.lo and
    mul.hi, from 16-bit halves so that int64 holds every step."""
    x0, x1, y0, y1 = x & LIMB_MASK, x >> 16, y & LIMB_MASK, y >> 16
    mid = x0 * y1 + x1 * y0
    low = x0 * y0 + ((mid & LIMB_MASK) << 16)
    return low & WORD, x1 * y1 + (mid >> 16) + (low >> 32)


def _add_at(t, v, at):
    """t (D + 1 words) plus the words v from word `at` up, carried up to the
    top word as a carry chain carries them; ArithmeticError where a carry
    would leave the top word (the kernel's accumulator is D + 1 words)."""
    t = t.clone()
    t[at:at + len(v)] += v
    while True:
        c = t >> 32
        if not bool(c.any()):
            return t
        if bool(c[-1].any()):
            raise ArithmeticError("digit product: a carry leaves the top "
                                  "word")
        t = t & WORD
        t[1:] += c[:-1]


def run_d32(F, a, b, stats=None):
    """mont_mul_d32 on (L, *batch) int64 limbs below 2^22 (L odd, p's top
    limb 0): both operands to D digits, then per row i: t += a_i b (the
    low halves from word 0, the high from word 1), m = t_0 n1 mod 2^32
    (mod 2^16 in the last row), t += m p, and the low word, now 0, dropped
    (the last row's t is 0 mod 2^16 and its quotient is read at a 16-bit
    offset). Returns (L, *batch) exact 16-bit limbs. `stats`, if given,
    gets the largest top word of t."""
    L = F.L
    if L % 2 == 0 or F.p_list[-1] != 0:
        raise ValueError(f"digit product: L = {L} must be odd and p's top "
                         "limb 0")
    D = (L + 1) // 2
    a, b = F._bc(a, b)
    x, y = _digits(a, L), _digits(b, L)
    pd = torch.tensor([F.p_list[2 * j] | F.p_list[2 * j + 1] << 16
                       for j in range(D - 1)], dtype=torch.int64,
                      device=a.device).reshape((D - 1,) + (1,) * (a.ndim - 1))
    k = n1(F)
    t = torch.zeros((D + 1,) + a.shape[1:], dtype=torch.int64,
                    device=a.device)
    for i in range(D):
        lo, hi = _mul_wide(x[i], y)
        t = _add_at(_add_at(t, lo, 0), hi, 1)
        m = _mul_wide(t[0], torch.full_like(t[0], k))[0]
        if i == D - 1:
            m = m & LIMB_MASK
        lo, hi = _mul_wide(m, pd)
        t = _add_at(_add_at(t, lo, 0), hi, 1)
        if stats is not None:
            stats["top"] = max(stats.get("top", 0),
                               int(t[D].max()) if t.numel() else 0)
        if i < D - 1:
            if bool(t[0].any()):
                raise ArithmeticError("digit product: round left a digit")
            t = torch.cat([t[1:], torch.zeros_like(t[:1])])
    if bool((t[0] & LIMB_MASK).any()):
        raise ArithmeticError("digit product: last round left 16 bits")
    limbs = []
    for j in range(D):
        limbs.append(t[j] >> 16)
        if 2 * j + 1 < L:
            limbs.append(t[j + 1] & LIMB_MASK)
    return torch.stack(limbs)
