"""Schedules of the lane-team kernels K2/K3 (G1 complete add and doubling
chain), K4/K5 (G2) and K6 (the merge combine of either group), as data.

The kernels (csrc/team.cuh) give each lane of a point batch to a team of
threads. The point, the constants and every intermediate live in the
block's shared memory as base-field *slots* (L uint32 limbs each: 17 on
BN254, 25 on BLS12-381, 11 on BN158); the formula runs in *levels*. In a
level every instruction is independent of the others, and the team
synchronises after it. On the lane executor team rank r executes
instructions r, r + T, r + 2T, ... (T threads per team, of one warp). On
the split executor (K2-K5 below ops/cuda.py SPLIT_BELOW) a team of T
threads runs each product on a sub-team of R ranks, split by product
columns (the split product of csrc/mont.cuh that K1's lane teams run,
modelled by k1_team.run), P = T / R products a round, and each linear
instruction on one warp, a lane a limb. An instruction is one of

  MUL    dst = (sa * sum(a)) (sb * sum(b)) R^-1   (one Montgomery product)
  LAZY   dst = sa * sum(a)                        (limbwise, no carries)
  EXACT  dst = sa * sum(a) + m p - sb * sum(b)    (exact 16-bit limbs)

over up to four operand slots a and b each (a wider lazy sum is first
gathered into a slot by a LAZY). Folding lazy sums and small
scales into operands keeps the values and limbs of the plain versions
(Curve._add_plain and Curve._dbl_plain over Field.mul, add, sub and
mul_small, or over Fp2's): a lazy add is a limbwise sum in either place.
A subtraction becomes an EXACT with the plain version's own value: m p is
Fp2.sub(k)'s exact k p for G2, and for G1 the multiple m p that the lazy
Field.sub(k) adds (Field.lift_limbs(k): m = 180 for k = 16 and 194 for
k = 32 on BN254, 247 and 266 on BLS12-381, 185 and 200 on BN158). Its
limbs may differ from
the lazy ones, but a Montgomery product depends only on its inputs'
values, and nothing is reordered across a subtraction, so every product
sees the values the plain version gives Field.mul, and every output
equals the plain version's once both are re-reduced.

This module builds each group's four schedules (the add, the add of a
reset lane, one doubling, the re-reduction after a chain), places each
level's instructions for the products a round holds (T on the lane
executor, P on the split one), allocates slots by liveness, and encodes
all of it, behind the constant rows the instructions read, as the uint32
*block* that ops/cuda.py appends to K1's modulus words in the group's
constant array (``block``; the split executor's ``split_block``). The
kernels execute that block: K2/K4 and K6 the add (K6 then makes the
merge's selects from its output slots, in a layout of its own from
MERGE_WIDE lanes up), K3/K5 the doubling and the re-reduction. ``run``
executes the same words with the base field's plain ops (``plain_add``,
``plain_dbl``, ``plain_merge``), each product split over its ranks as the
split executor runs it where the block says so; the CPU tests hold it
against the plain versions.
"""

from __future__ import annotations

import functools

import torch

from . import k1_team

MUL, LAZY, EXACT = 0, 1, 2
CONST0 = 240                  # slot ids >= CONST0 are constant rows:
ONE, C1, C2 = 240, 241, 242   # R mod p; G2 the twist's 3b' c0 and c1, G1
#                               9b and 3b in Montgomery form
ROWS = 8                      # constant rows: 3 slots, then 5 EXACT slacks
ADD, RESET, DBL, FRESH = range(4)    # the schedules, in table order
ADD_KERNEL = (ADD, RESET)            # K2/K4 run these (K6 ADD), K3/K5 DBL
#                                      and FRESH
N_OUT = 6                            # output slot room per list (header)
KINDS = 3                            # kernel kinds: add, doubling, merge
WIDE, LEVELS, INSTRS = 9, 10, 11     # header words after the layouts,
RANGES, OUTS = 12, 20                # then the ranges and output slots,
RANKS = OUTS + 3 * N_OUT             # the ranks a product of each kind
HDR = RANKS + KINDS                  # header words of the table
# Lane-team layouts, (threads per team, warps per block) of the add kernel
# (K2/K4), of the doubling kernel (K3/K5) and of the merge kernel (K6) at
# MERGE_WIDE lanes and more (narrower K6 launches take the add's), from
# team_sweep.py on the H100 (PERF.md)
LAYOUT = {"g1": ((6, 4), (3, 2), (3, 2)), "g2": ((8, 2), (8, 2), (8, 2))}
# Split-executor layouts per group and limb count, (threads per team,
# warps per block, ranks per product) of the add kernel (K2/K4) and of the
# doubling kernel (K3/K5): a team of one warp (W lanes a block) or of a
# whole block (W = T / 32), R in SPLIT_RANKS dividing T; from team_sweep.py
# on the H100 (PERF.md). At 25 limbs, G2 (run AD5): 16 products a round
# of 16 ranks, 5 rounds an add and 3 a doubling, the least time at 1-256
# lanes; G1 (run AE1): its widest level has 6 products (a doubling's 4), so
# a team of 6 products a round of 32 ranks, a warp each (3 rounds an add),
# and of 4 for the doubling (3 rounds), the least summed time below the
# width rule. At 11 limbs, where a product has 22 columns: the adds (run
# AG1) G2 32 products a round of 8 ranks (5 rounds), G1 12 products a
# round of 16 ranks (4 rounds); the doublings, picked by the BN158 paths'
# launches (run AH2, team_sweep.py --paths: every doubling below the rule
# is the msm's Horner step at 1 lane x 8), in their add's layouts: G2 3
# rounds of up to 32 products, G1 3 rounds of up to 12. At 17 limbs (34
# columns), picked by the BN254 paths' launches, main, msm and multiproof
# (run AI1, team_sweep.py --paths): G2 16 products a round of 16 ranks (3
# columns a rank; 5 rounds an add, 3 a doubling), G1 12 products a round
# of 16 ranks for the add (3 rounds) and 6 of 32 ranks for the doubling
# (3 rounds); the doublings' picks held by run AJ1's re-sweep (G2 0.0616
# ms at 1 x 8 against (128, 4, 8)'s 0.0701, G1 0.0433 against the add's
# layout's 0.0461), shipped below cuda.SPLIT_BELOW's 17-limb rules
SPLIT_LAYOUT = {"g1": {25: ((192, 6, 32), (128, 4, 32)),
                       11: ((192, 6, 16), (192, 6, 16)),
                       17: ((192, 6, 16), (192, 6, 32))},
                "g2": {25: ((256, 8, 16), (256, 8, 16)),
                       11: ((256, 8, 8), (256, 8, 8)),
                       17: ((256, 8, 16), (256, 8, 16))}}
SPLIT_RANKS = (8, 16, 32)            # the R the split kernels are built for
SPLIT_MAX_THREADS = 288              # team.cuh: a split block, at most
MERGE_WIDE = 8192
# The limb counts at which K6 runs the add's products on 32-bit digits
# (csrc/msm_merge.cu MERGE_DIGITS, mont.cuh mont_mul_d32; the same limbs as
# mont_mul's): BLS12-381's 25, where team_sweep.py merge / merge-g2 on the
# H100 found the digit product as fast or faster at every merge level
# (PERF.md); at 17 and 11 it was slower at G1's widest level
MERGE_DIGITS = (25,)
KP2 = (0, 2, 4, 16, 32)              # G2 EXACT slacks, multiples of p


class _Prog:
    """A straight-line program over base-field values. A node is an int:
    an input, a constant slot id (>= CONST0) or an instruction. A *sum* is
    (scale, nodes): the lazy value scale * sum(nodes). `kps`: the multiples
    of p that EXACT may add (the slack rows)."""

    def __init__(self, n_in, kps, qnr=-1):
        self.n_in = n_in
        self.kps = kps
        self.qnr = qnr               # G2: Fp2's non-residue, -1 or small
        self.ins = []                # (kind, dst node, a sum, b sum, kp idx)
        self._gathered = {}          # nodes -> the LAZY that summed them

    def _narrow(self, x):
        """An operand of at most four slots: the first four of a wider sum
        gathered by one LAZY (made once per set of nodes)."""
        scale, nodes = x
        while len(nodes) > 4:
            head = nodes[:4]
            if head not in self._gathered:
                self._gathered[head] = self._emit(LAZY, (1, head))
            nodes = (self._gathered[head],) + nodes[4:]
        return scale, nodes

    def _emit(self, kind, a, b=(1, ()), kp=0):
        a, b = self._narrow(a), self._narrow(b)
        node = CONST0 + 16 + len(self.ins)     # past every slot id
        self.ins.append((kind, node, a, b, kp))
        return node

    def mul(self, a, b):
        return self._emit(MUL, a, b)

    def lazy(self, a):
        return self._emit(LAZY, a)

    def exact(self, a, m, b):
        return self._emit(EXACT, a, b, self.kps.index(m))

    def fresh(self, a):
        """The re-reduction of a sum: times Montgomery 1."""
        return self.mul(a, _s(ONE))


def _s(*nodes, scale=1):
    return (scale, tuple(nodes))


def _cat(x, y):
    """Lazy sum of two sums of the same scale."""
    if x[0] != y[0]:
        raise ValueError("lazy sums of different scales")
    return (x[0], x[1] + y[1])


def _scale(x, s):
    return (x[0] * s, x[1])


# ----------------------------------------------------------------------
# G1 (Curve._add_plain / _dbl_plain over Field, a = 0): base elements x,
# y, z; 3b as Field.mul_const takes it, a small scale when 3b <= 14
# (BN254: 3b = 6, BLS12-381: 12) and else a product by its Montgomery form
# in row C2 (BN158: 39); 9b a product by row C1, the branch the plain
# doubling takes when 9b > 15 (ops/cuda.py _g1_consts checks it)
# ----------------------------------------------------------------------

def _slot(pg, x):
    """The node of a sum that is one slot as it is, else a LAZY of it."""
    return x[1][0] if x[0] == 1 and len(x[1]) == 1 else pg.lazy(x)


def _mul_b3(pg, x, b3):
    """3b x as Curve._mul_b3 gives it: a lazy scale of the sum x, or a
    product by row C2."""
    if b3 <= 14:
        return _scale(x, b3)
    return _s(pg.mul(x, _s(C2)))


def _g1_add(b3, m16, kps):
    """RCB15 Alg 7, then every output re-reduced."""
    pg = _Prog(6, kps)
    X1, Y1, Z1, X2, Y2, Z2 = range(6)
    t0 = pg.mul(_s(X1), _s(X2))
    t1 = pg.mul(_s(Y1), _s(Y2))
    t2 = pg.mul(_s(Z1), _s(Z2))
    tA = pg.mul(_s(X1, Y1), _s(X2, Y2))
    tB = pg.mul(_s(Y1, Z1), _s(Y2, Z2))
    tC = pg.mul(_s(X1, Z1), _s(X2, Z2))
    t3 = pg.exact(_s(tA), m16, _s(t0, t1))            # X1Y2 + X2Y1
    t4 = pg.exact(_s(tB), m16, _s(t1, t2))            # Y1Z2 + Y2Z1
    t5 = pg.exact(_s(tC), m16, _s(t0, t2))            # X1Z2 + X2Z1
    Ft = _mul_b3(pg, _s(t2), b3)                      # 3b Z1Z2
    Zt = _s(t1, _slot(pg, Ft))                        # Y1Y2 + 3bZ1Z2
    M = _s(pg.exact(_s(t1), m16, Ft))                 # Y1Y2 - 3bZ1Z2
    G = _mul_b3(pg, _s(t5), b3)                       # 3b (X1Z2 + X2Z1)
    t03 = _s(t0, scale=3)                             # 3 X1X2
    X3 = pg.exact(_s(pg.mul(_s(t3), M)), m16, _s(pg.mul(_s(t4), G)))
    Y3 = _s(pg.mul(M, Zt), pg.mul(t03, G))
    Z3 = _s(pg.mul(_s(t4), Zt), pg.mul(_s(t3), t03))
    out = [pg.fresh(_s(X3)), pg.fresh(Y3), pg.fresh(Z3)]
    return pg, range(6), out, {}


def _g1_reset(kps):
    """A reset lane's output: Q re-reduced."""
    pg = _Prog(6, kps)
    return pg, range(3, 6), [pg.fresh(_s(e)) for e in range(3, 6)], {}


def _g1_dbl(b3, m32, kps):
    """RCB15 Alg 9: X3 = 2 Xa, Y3 = Ya + X3', Z3, left in the input
    slots."""
    pg = _Prog(3, kps)
    X, Y, Z = range(3)
    t0 = pg.mul(_s(Y), _s(Y))
    t1 = pg.mul(_s(Y), _s(Z))
    zz = pg.mul(_s(Z), _s(Z))
    xy = pg.mul(_s(X), _s(Y))
    t2 = _mul_b3(pg, _s(zz), b3)                      # 3b Z^2
    Y3t = _s(t0, _slot(pg, t2))                       # Y^2 + 3b Z^2
    X3 = pg.mul(t2, _s(t0, scale=8))                  # 3b Z^2 8 Y^2
    Z3 = pg.mul(_s(t1), _s(t0, scale=8))
    t29 = pg.mul(_s(zz), _s(C1))                      # 9b Z^2
    t0 = pg.exact(_s(t0), m32, _s(t29))               # Y^2 - 9b Z^2
    Ya = pg.mul(_s(t0), Y3t)
    Xa = pg.mul(_s(t0), _s(xy))
    out = [pg.lazy(_s(Xa, scale=2)), pg.lazy(_s(Ya, X3)), Z3]
    return pg, range(3), out, {n: i for i, n in enumerate(out)}


def _g1_fresh(kps):
    """The end of a chain: the point in 0-2 re-reduced."""
    pg = _Prog(3, kps)
    return pg, range(3), [pg.fresh(_s(e)) for e in range(3)], {}


# ----------------------------------------------------------------------
# G2 (the same formulas over Fp2 = Fp[u]/(u^2 - qnr), qnr = -1 on BN254
# and BLS12-381, 5 on BN158): Fp2 values are pairs of sums (c0, c1); base
# elements x.c0, x.c1, y.c0, y.c1, z.c0, z.c1
# ----------------------------------------------------------------------

def _f2(c0, c1):
    return (_s(c0), _s(c1))


def _f2_add(A, B):
    return (_cat(A[0], B[0]), _cat(A[1], B[1]))


def _f2_small(A, s):
    return (_scale(A[0], s), _scale(A[1], s))


def _f2_mul(pg, A, B):
    """Fp2.mul: Karatsuba, c1 = t + 4p - (v0 + v1) exact; c0 = v0 + 2p - v1
    exact for qnr = -1, else the lazy v0 + qnr v1."""
    v0 = pg.mul(A[0], B[0])
    v1 = pg.mul(A[1], B[1])
    t = pg.mul(_cat(A[0], A[1]), _cat(B[0], B[1]))
    if pg.qnr == -1:
        c0 = _s(pg.exact(_s(v0), 2, _s(v1)))
    else:
        c0 = _s(v0, pg.lazy(_s(v1, scale=pg.qnr)))
    return c0, _s(pg.exact(_s(t), 4, _s(v0, v1)))


def _f2_sub(pg, A, B, k):
    return _f2(pg.exact(A[0], k, B[0]), pg.exact(A[1], k, B[1]))


def _f2_fresh(pg, A):
    return [pg.fresh(A[0]), pg.fresh(A[1])]


B3 = _f2(C1, C2)


def _g2_add(qnr):
    """Curve._add_plain over Fp2 (RCB15 Alg 7, a = 0), then every output
    component re-reduced."""
    pg = _Prog(12, KP2, qnr)
    X1, Y1, Z1, X2, Y2, Z2 = [_f2(2 * i, 2 * i + 1) for i in range(6)]
    t0 = _f2_mul(pg, X1, X2)
    t1 = _f2_mul(pg, Y1, Y2)
    t2 = _f2_mul(pg, Z1, Z2)
    tA = _f2_mul(pg, _f2_add(X1, Y1), _f2_add(X2, Y2))
    tB = _f2_mul(pg, _f2_add(Y1, Z1), _f2_add(Y2, Z2))
    tC = _f2_mul(pg, _f2_add(X1, Z1), _f2_add(X2, Z2))
    t3 = _f2_sub(pg, tA, _f2_add(t0, t1), 16)          # X1Y2 + X2Y1
    t4 = _f2_sub(pg, tB, _f2_add(t1, t2), 16)          # Y1Z2 + Y2Z1
    t5 = _f2_sub(pg, tC, _f2_add(t0, t2), 16)          # X1Z2 + X2Z1
    Ft = _f2_mul(pg, t2, B3)                           # 3b' Z1Z2
    Zt = _f2_add(t1, Ft)                               # Y1Y2 + 3b'Z1Z2
    M = _f2_sub(pg, t1, Ft, 16)                        # Y1Y2 - 3b'Z1Z2
    G = _f2_mul(pg, t5, B3)                            # 3b'(X1Z2 + X2Z1)
    t03 = _f2_small(t0, 3)                             # 3 X1X2
    X3a, X3b = _f2_mul(pg, t3, M), _f2_mul(pg, t4, G)
    Y3a, Y3b = _f2_mul(pg, M, Zt), _f2_mul(pg, t03, G)
    Z3a, Z3b = _f2_mul(pg, t4, Zt), _f2_mul(pg, t3, t03)
    X3 = _f2_sub(pg, X3a, X3b, 16)
    Y3 = _f2_add(Y3a, Y3b)
    Z3 = _f2_add(Z3a, Z3b)
    out = _f2_fresh(pg, X3) + _f2_fresh(pg, Y3) + _f2_fresh(pg, Z3)
    return pg, range(12), out, {}


def _g2_reset():
    """A reset lane's output: Q re-reduced."""
    pg = _Prog(12, KP2)
    return pg, range(6, 12), [pg.fresh(_s(e)) for e in range(6, 12)], {}


def _g2_dbl(qnr):
    """The Fp2 branch of Curve._dbl_plain (RCB15 Alg 9, a = 0): X3 = 2 Xa,
    Y3 = Ya + X3', Z3, left in the input slots."""
    pg = _Prog(6, KP2, qnr)
    X, Y, Z = [_f2(2 * i, 2 * i + 1) for i in range(3)]
    t0 = _f2_mul(pg, Y, Y)
    t1 = _f2_mul(pg, Y, Z)
    zz = _f2_mul(pg, Z, Z)
    xy = _f2_mul(pg, X, Y)
    e8 = _f2_small(t0, 8)                              # 8 Y^2
    t2 = _f2_mul(pg, zz, B3)                           # 3b' Z^2
    Y3t = _f2_add(t0, t2)                              # Y^2 + 3b' Z^2
    X3 = _f2_mul(pg, t2, e8)
    Z3 = _f2_mul(pg, t1, e8)
    t0 = _f2_sub(pg, t0, _f2_small(t2, 3), 32)         # Y^2 - 9b' Z^2
    Ya = _f2_mul(pg, t0, Y3t)
    Xa = _f2_mul(pg, t0, xy)
    Yn = _f2_add(Ya, X3)
    Xn = _f2_small(Xa, 2)
    out = [_slot(pg, c) for c in Xn + Yn + Z3]
    return pg, range(6), out, {n: i for i, n in enumerate(out)}


def _g2_fresh():
    """The end of a chain: the point in 0-5 re-reduced."""
    pg = _Prog(6, KP2)
    return pg, range(6), [pg.fresh(_s(e)) for e in range(6)], {}


# ----------------------------------------------------------------------
# level placement, slot allocation, encoding
# ----------------------------------------------------------------------

def _reads(ins):
    kind, _, a, b, _ = ins
    return a[1] + (b[1] if kind != LAZY else ())


def _levels(pg, per_round):
    """Place each instruction in a level (product levels even, linear
    levels odd). The depth is the as-soon-as-possible placement's; each
    instruction also has a latest level that keeps that depth. Linear
    instructions go as soon as they can. A product level is opened only
    for the products that cannot wait, and is then filled up to a whole
    number of team rounds (a multiple of `per_round`, the products a round
    holds) with products that are ready, those that must go soonest first.
    Empty levels go."""
    kind = {ins[1]: ins[0] for ins in pg.ins}
    reads = {ins[1]: [n for n in _reads(ins) if n in kind] for ins in pg.ins}
    asap = {}
    for ins in pg.ins:
        n = ins[1]
        dep = max([asap[d] for d in reads[n]], default=-1)
        want = 0 if kind[n] == MUL else 1
        asap[n] = dep + 1 + ((dep + 1 - want) % 2)
    depth = max(asap.values()) + 1
    readers = {n: [] for n in kind}
    for n, ds in reads.items():
        for d in ds:
            readers[d].append(n)
    alap = {}
    for ins in reversed(pg.ins):
        n = ins[1]
        late = min([alap[r] - 1 for r in readers[n]], default=depth - 1)
        alap[n] = late - ((late - (0 if kind[n] == MUL else 1)) % 2)
    lv = {}
    for level in range(depth):
        ready = [n for n in kind if n not in lv
                 and (kind[n] == MUL) == (level % 2 == 0)
                 and all(d in lv and lv[d] < level for d in reads[n])]
        if level % 2:
            lv.update({n: level for n in ready})
            continue
        must = [n for n in ready if alap[n] == level]
        if not must:
            continue
        rounds = -(-len(must) // per_round)
        extra = sorted((n for n in ready if alap[n] > level),
                       key=lambda n: alap[n])
        for n in must + extra[:rounds * per_round - len(must)]:
            lv[n] = level
    if len(lv) != len(kind):
        raise AssertionError("an instruction found no level")
    order = sorted(set(lv.values()))
    return {n: order.index(v) for n, v in lv.items()}, len(order)


def _alloc(pg, inputs, outputs, pinned, lv, n_lv):
    """Slots by liveness: a value holds its slot from the level that writes
    it (inputs: -1) to the last level that reads it (outputs: the end). Two
    values share a slot only if one's last read comes before the other's
    write, so no level reads a slot that it also writes."""
    last = {}
    for ins in pg.ins:
        for n in _reads(ins):
            last[n] = max(last.get(n, -1), lv[ins[1]])
    for n in outputs:
        last[n] = n_lv
    live = {n: (-1, last.get(n, -1)) for n in range(pg.n_in)}
    live.update({ins[1]: (lv[ins[1]], last.get(ins[1], lv[ins[1]]))
                 for ins in pg.ins})
    slot = {n: n for n in inputs}
    for n, s in pinned.items():
        slot[n] = s
    taken = {}
    for n, s in slot.items():
        taken.setdefault(s, []).append(live[n])

    def free(s, iv):
        return all(iv[1] < d or l < iv[0] for d, l in taken.get(s, []))

    for ins in sorted(pg.ins, key=lambda i: lv[i[1]]):
        n = ins[1]
        if n in slot:
            continue
        s = next(s for s in range(CONST0) if free(s, live[n]))
        slot[n] = s
        taken.setdefault(s, []).append(live[n])
    for n in pinned:                 # a pinned slot is free when written
        s, iv = slot[n], live[n]
        clash = [m for m, t in slot.items() if t == s and m != n
                 and not (live[m][1] < iv[0] or iv[1] < live[m][0])]
        if clash:
            raise ValueError(f"pinned slot {s} still live at level {iv[0]}")
    return slot


def _encode_sum(x, slot):
    s, nodes = x
    ids = [n if CONST0 <= n < CONST0 + 16 else slot[n] for n in nodes]
    word = 0
    for i, v in enumerate(ids):
        word |= v << (8 * i)
    return s, len(ids), word


def _key(G):
    """What a group's table depends on: G2's takes Fp2's non-residue (-1 or
    a small qnr); G1's takes 3b and the lift multiples of the field's lazy
    subtractions."""
    if G.is_fp2:
        return ("g2", -1 if G.F.qnr_is_m1 else G.F.qnr_small)
    F = G.F
    return ("g1", G._b3_int, F.lift_limbs(16)[1], F.lift_limbs(32)[1])


def _kps(key):
    return KP2 if key[0] == "g2" else (0,) + key[2:]


@functools.lru_cache(maxsize=None)
def _table(key, layout):
    """layout: (threads per team, warps per block, ranks per product) of
    each kind."""
    kps = _kps(key)
    if key[0] == "g2":
        progs = (_g2_add(key[1]), _g2_reset(), _g2_dbl(key[1]), _g2_fresh())
    else:
        _, b3, m16, m32 = key
        progs = (_g1_add(b3, m16, kps), _g1_reset(kps),
                 _g1_dbl(b3, m32, kps), _g1_fresh(kps))
    levels, instrs, ranges, outs = [], [], [], []
    n_slots = [0, 0, 0]
    for sched, (pg, inputs, out, pinned) in enumerate(progs):
        kernel = 0 if sched in ADD_KERNEL else 1
        team, _, ranks = layout[kernel]
        lv, n_lv = _levels(pg, team // ranks)
        slot = _alloc(pg, inputs, out, pinned, lv, n_lv)
        n_slots[kernel] = max(n_slots[kernel], pg.n_in,
                              1 + max(slot.values()))
        ranges.append((len(levels), len(levels) + n_lv))
        for level in range(n_lv):
            here = [i for i in pg.ins if lv[i[1]] == level]
            levels.append(len(instrs) | len(here) << 16)
            for kind, node, a, b, kp in here:
                sa, na, wa = _encode_sum(a, slot)
                sb, nb, wb = _encode_sum(b, slot)
                if sa >= 64 or sb >= 64 or slot[node] >= CONST0:
                    raise ValueError("scale or slot out of range")
                instrs.append((kind | slot[node] << 2 | sa << 10 | sb << 16
                               | na << 22 | nb << 25 | kp << 28, wa, wb))
        if sched != DBL:
            outs += [slot[n] for n in out] + [0] * (N_OUT - len(out))
    n_slots[2] = n_slots[0]                  # K6 runs the add's schedule
    words = [v for k in range(KINDS) for v in (*layout[k][:2], n_slots[k])]
    words += [MERGE_WIDE, len(levels), len(instrs)]
    words += [v for r in ranges for v in r] + outs
    words += [layout[k][2] for k in range(KINDS)] + levels
    words += [w for ins in instrs for w in ins]
    return tuple(words)


def table(G, layout=None):
    """The encoded schedules of G's group (G1 or G2) for lane-team layouts
    `layout` = ((threads per team, warps per block) of the add kernel, the
    same of the doubling kernel and of the merge kernel), default LAYOUT;
    uint32 words:
      [3 k], [3 k + 1], [3 k + 2]: threads per team, warps per block and
          slots per lane of kernel kind k: the add kernel (ADD, RESET), the
          doubling kernel (DBL, FRESH), the merge kernel (ADD, at WIDE
          lanes and more),
      [WIDE] the narrowest K6 launch that takes the merge kernel's layout,
      [LEVELS] levels, [INSTRS] instructions,
      [RANGES + 2 s], [RANGES + 2 s + 1]: first and end level of schedule
          s (ADD, RESET, DBL, FRESH),
      [OUTS ...]: the output slots of ADD, RESET and FRESH (N_OUT each; G1
          uses 3, the rest 0),
      [RANKS + k]: the ranks a product of kind k: 1 (one thread, the lane
          executor's table) or R (split_table),
      then one word per level: first instruction | count << 16,
      then three words per instruction:
        kind | dst << 2 | sa << 10 | sb << 16 | na << 22 | nb << 25
             | kp << 28,  a slots (4 x 8 bits),  b slots (4 x 8 bits)."""
    if layout is None:
        layout = LAYOUT["g2" if G.is_fp2 else "g1"]
    return _table(_key(G), tuple((*v, 1) for v in layout))


def _check_split(team, warps, ranks):
    """A split-executor layout as team.cuh split_prepare takes it."""
    warp = team == 32 and 1 <= warps and 32 * warps <= SPLIT_MAX_THREADS
    block = (team > 32 and team % 32 == 0 and 32 * warps == team
             and team <= SPLIT_MAX_THREADS)
    if not (warp or block) or ranks not in SPLIT_RANKS or team % ranks:
        raise ValueError(
            f"split layout {(team, warps, ranks)}: a team of one warp (W "
            f"lanes a block, 32 W <= {SPLIT_MAX_THREADS}) or of a whole "
            f"block (W = T / 32, T <= {SPLIT_MAX_THREADS}), ranks in "
            f"{SPLIT_RANKS} dividing T")


def split_layout(G):
    """The shipped split layout of group G (SPLIT_LAYOUT of its group at
    its base field's limb count); ValueError where there is none."""
    grp, L = ("g2", G.F.base.L) if G.is_fp2 else ("g1", G.F.L)
    if L not in SPLIT_LAYOUT[grp]:
        raise ValueError(f"{G.name}: no split-executor layout at {L} limbs "
                         f"(SPLIT_LAYOUT[{grp!r}]: "
                         f"{sorted(SPLIT_LAYOUT[grp])})")
    return SPLIT_LAYOUT[grp][L]


def split_table(G, layout=None):
    """The table of the split executor (K2/K3 or K4/K5) for group G: the
    same schedules leveled for P = T / R products a round, under `layout` =
    ((threads per team, warps per block, ranks per product) of the add
    kernel, the same of the doubling kernel), default split_layout(G). The
    merge kind's words repeat the add's (K6 runs the lane executor)."""
    add, dbl = split_layout(G) if layout is None else layout
    for lay in (add, dbl):
        _check_split(*lay)
    return _table(_key(G), (tuple(add), tuple(dbl), tuple(add)))


def _limbs(v, L):
    return [(v >> (16 * i)) & 0xFFFF for i in range(L)]


def rows(G):
    """The constant rows the instructions read, ROWS x L uint32 words:
    slots ONE, C1, C2 (G2: R mod p, 3b' c0, 3b' c1; G1: R mod p, 9b and 3b
    in Montgomery form), then the exact 16-bit limbs of m p for each EXACT
    slack index (zero rows past the group's)."""
    B = G.F.base if G.is_fp2 else G.F
    L, p = B.L, B.modulus
    one = list(B.params.one_limbs)
    if G.is_fp2:
        b3 = G._b3.cpu().tolist()                # (2, L) Montgomery limbs
        cst = [one, b3[0], b3[1]]
    else:
        m3 = G._b3_int * B.params.mont_r % p
        cst = [one, _limbs(3 * m3 % p, L), _limbs(m3, L)]
    slack = [_limbs(m * p, L) for m in _kps(_key(G))]
    slack += [[0] * L] * (ROWS - 3 - len(slack))
    return [int(v) for r in cst + slack for v in r]


def block(G, layout=None):
    """What the kernels of G's group read behind its constants: rows(G),
    then table(G, layout)."""
    return rows(G) + list(table(G, layout))


def split_block(G, layout=None):
    """What the split K2-K5 kernels read behind the constants: rows(G),
    then split_table(G, layout)."""
    return rows(G) + list(split_table(G, layout))


def rounds(words):
    """Product rounds of a team per schedule (ADD, RESET, DBL, FRESH): sum
    over its product levels of ceil(products / products a round), the
    products a round being threads per team / ranks per product."""
    ranges, _, lv, ins = _decode(words)
    kinds = [0 if s in ADD_KERNEL else 1 for s in range(4)]
    per = [words[3 * k] // words[RANKS + k] for k in kinds]
    return [sum(-(-(w >> 16) // n) for w in lv[slice(*r)]
                if ins[3 * (w & 0xFFFF)] & 3 == MUL)
            for r, n in zip(ranges, per)]


# ----------------------------------------------------------------------
# the plain interpreter of the block (the kernels' executor, in PyTorch)
# ----------------------------------------------------------------------

def _decode(words):
    n_lv, n_ins = words[LEVELS], words[INSTRS]
    ranges = [tuple(words[RANGES + 2 * s:RANGES + 2 * s + 2])
              for s in range(4)]
    outs = [list(words[OUTS + N_OUT * i:OUTS + N_OUT * (i + 1)])
            for i in range(3)]
    lv = words[HDR:HDR + n_lv]
    ins = words[HDR + n_lv:HDR + n_lv + 3 * n_ins]
    return ranges, outs, lv, ins


def _out(sched, words, n):
    """The first n output slots of ADD, RESET or FRESH."""
    return _decode(words)[1][(ADD, RESET, FRESH).index(sched)][:n]


def _operand(slots, cst, scale, n, word):
    v = None
    for q in range(n):
        s = (word >> (8 * q)) & 0xFF
        x = cst[s - CONST0] if s >= CONST0 else slots[s]
        v = x if v is None else v + x
    return v * scale


def run(F, blk, sched, slots, stats=None, d32=False):
    """Execute schedule `sched` of the block `blk` (rows, then table) over
    `slots` (a list of (L, *batch) limb tensors of the base field F, at
    least the schedule's inputs filled) with F's plain ops, as the kernel
    does, in place: a product by Field._mul_plain where the table gives its
    kind one rank a product (the lane executor), else split over its R
    ranks by k1_team.run, the split executor's product rank by rank; with
    `d32`, by k1_team.run_d32, the lane executor's product on 32-bit
    digits (K6's at the limb counts of MERGE_DIGITS). With `stats` (a dict),
    record the bounds of every product's inputs (bound_stats). Returns
    `slots`."""
    L = F.L
    words = blk[ROWS * L:]
    ranges, _, lv, ins = _decode(words)
    ranks = words[RANKS + (0 if sched in ADD_KERNEL else 1)]
    if d32:
        def mul(a, b):
            return k1_team.run_d32(F, a, b)
    elif ranks == 1:
        mul = F._mul_plain
    else:
        tab = k1_team.table(L, (ranks, 1))

        def mul(a, b):
            return k1_team.run(F, a, b, tab)
    ndim = next(s.ndim for s in slots if s is not None)
    cst = [torch.tensor(blk[r * L:(r + 1) * L], dtype=torch.int64,
                        device=F.device).reshape((L,) + (1,) * (ndim - 1))
           for r in range(ROWS)]
    slots.extend([None] * (max(words[2], words[5]) - len(slots)))
    for level in range(*ranges[sched]):
        first, count = lv[level] & 0xFFFF, lv[level] >> 16
        res = []
        for i in range(first, first + count):
            w0, wa, wb = ins[3 * i:3 * i + 3]
            kind, dst = w0 & 3, (w0 >> 2) & 0xFF
            sa, sb = (w0 >> 10) & 63, (w0 >> 16) & 63
            na, nb, kp = (w0 >> 22) & 7, (w0 >> 25) & 7, (w0 >> 28) & 7
            a = _operand(slots, cst, sa, na, wa)
            if kind == LAZY:
                res.append((dst, a))
                continue
            b = _operand(slots, cst, sb, nb, wb)
            if kind == MUL:
                a, b = F._bc(a, b)
                if stats is not None:
                    bound_stats(stats, a, b, F)
                res.append((dst, mul(a, b)))
                continue
            t = F._norm16(a + cst[3 + kp])
            d, ok = F._sub_chain(list(t), list(F._norm16(b)))
            if not bool(torch.all(ok == 1)):
                raise ArithmeticError("exact subtraction went negative")
            res.append((dst, torch.stack(d, dim=0)))
        for dst, v in res:           # the level's writes land after its reads
            slots[dst] = v
    return slots


def bound_stats(stats, a, b, F):
    """Record, over the product inputs a and b (equally shaped (L, *batch)
    limbs of F), the largest limb, the largest value and the largest
    product a b, as exact ints: a Montgomery product's output is below
    a b / R + p."""
    def ints(x):
        return [sum(v << (16 * k) for k, v in enumerate(col))
                for col in x.reshape(F.L, -1).T.tolist()]

    va, vb = ints(a), ints(b)
    stats["limb"] = max(stats.get("limb", 0), int(a.max()), int(b.max()))
    stats["value"] = max(stats.get("value", 0), *va, *vb)
    stats["ab"] = max(stats.get("ab", 0), *(x * y for x, y in zip(va, vb)))


def _split(G, P):
    if G.is_fp2:
        return [P[k][c] for k in ("x", "y", "z") for c in (0, 1)]
    return [P[k] for k in ("x", "y", "z")]


def _join(G, vals):
    if G.is_fp2:
        return {k: torch.stack(vals[2 * i:2 * i + 2], dim=0)
                for i, k in enumerate(("x", "y", "z"))}
    return dict(zip(("x", "y", "z"), vals))


def plain_add(G, P, Q, reset=None, blk=None, stats=None, d32=False):
    """K2's (G1) or K4's (G2) schedules run by `run` on point dicts of the
    base field's device: reset ? Q re-reduced : P + Q, every output
    re-reduced. blk: the block to run (default block(G)); d32: the
    products on 32-bit digits (run)."""
    B = G.F.base if G.is_fp2 else G.F
    blk = block(G) if blk is None else blk
    words = blk[ROWS * B.L:]
    P, Q = [{k: v.expand(torch.broadcast_shapes(P[k].shape, Q[k].shape))
             for k, v in X.items()} for X in (P, Q)]
    n = 6 if G.is_fp2 else 3
    slots = run(B, blk, ADD, _split(G, P) + _split(G, Q), stats, d32)
    out = _join(G, [slots[s] for s in _out(ADD, words, n)])
    if reset is not None:
        slots = run(B, blk, RESET, [None] * n + _split(G, Q), stats, d32)
        out = G.select(reset, _join(G, [slots[s] for s in
                                        _out(RESET, words, n)]), out)
    return out


def plain_dbl(G, P, times, blk=None, stats=None):
    """K3's (G1) or K5's (G2) schedules: `times` doublings, then the
    re-reduction."""
    B = G.F.base if G.is_fp2 else G.F
    blk = block(G) if blk is None else blk
    n = 6 if G.is_fp2 else 3
    slots = _split(G, P)
    for _ in range(times):
        slots = run(B, blk, DBL, slots, stats)
    slots = run(B, blk, FRESH, slots, stats)
    return _join(G, [slots[s] for s in _out(FRESH, blk[ROWS * B.L:], n)])


def plain_merge(G, aL, aR, bL, bR, fuse, asing, bsing, blk=None,
                d32=None):
    """K6's program: the add's schedule over (aR, bL) by `run` gives mid,
    its products on 32-bit digits where `d32` says so (default: as K6 runs
    them, at the limb counts of MERGE_DIGITS); newL = (fuse & asing) ? mid
    : aL, newR = (fuse & bsing) ? mid : bR, the kept lanes' limbs
    unchanged."""
    if d32 is None:
        d32 = (G.F.base if G.is_fp2 else G.F).L in MERGE_DIGITS
    mid = plain_add(G, aR, bL, blk=blk, d32=d32)
    newL = G.select(torch.logical_and(fuse, asing), mid, aL)
    newR = G.select(torch.logical_and(fuse, bsing), mid, bR)
    return mid, newL, newR
