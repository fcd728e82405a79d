"""Schedules of the lane-team kernels K2/K3 (G1 complete add and doubling
chain), K4/K5 (G2) and K6 (the merge combine of either group), as data.

The kernels (csrc/team.cuh) give each lane of a point batch to a team of
threads inside one warp. The point, the constants and every
intermediate live in the block's shared memory as base-field *slots* (17
uint32 limbs each); the formula runs in *levels*. In a level every
instruction is independent of the others, team rank r executes
instructions r, r + T, r + 2T, ... (T threads per team), and the team
synchronises after it. An instruction is one of

  MUL    dst = (sa * sum(a)) (sb * sum(b)) R^-1   (one Montgomery product)
  LAZY   dst = sa * sum(a)                        (limbwise, no carries)
  EXACT  dst = sa * sum(a) + m p - sb * sum(b)    (exact 16-bit limbs)

over up to four operand slots a and b each. Folding lazy sums and small
scales into operands keeps the values and limbs of the plain versions
(Curve._add_plain and Curve._dbl_plain over Field.mul, add, sub and
mul_small, or over Fp2's): a lazy add is a limbwise sum in either place.
A subtraction becomes an EXACT with the plain version's own value: m p is
Fp2.sub(k)'s exact k p for G2, and for G1 the multiple m p that the lazy
Field.sub(k) adds (Field.lift_limbs(k): m = 180 for k = 16 and 194 for
k = 32 on BN254). Its limbs may differ from the lazy ones, but a Montgomery
product depends only on its inputs' values, and nothing is reordered
across a subtraction, so every product sees the values the plain version
gives Field.mul, and every output equals the plain version's once both
are re-reduced.

This module builds each group's four schedules (the add, the add of a
reset lane, one doubling, the re-reduction after a chain), places each
level's instructions, allocates slots by liveness, and encodes all of it,
behind the constant rows the instructions read, as the uint32 *block* that
ops/cuda.py appends to K1's modulus words in the group's constant array.
The kernels execute that block: K2/K4 and K6 the add (K6 then makes the
merge's selects from its output slots, in a layout of its own from
MERGE_WIDE lanes up), K3/K5 the doubling and the re-reduction. ``run``
executes the same words with the base field's plain ops (``plain_add``,
``plain_dbl``, ``plain_merge``), which the CPU tests hold against the
plain versions.
"""

from __future__ import annotations

import functools

import torch

MUL, LAZY, EXACT = 0, 1, 2
CONST0 = 240                  # slot ids >= CONST0 are constant rows:
ONE, C1, C2 = 240, 241, 242   # R mod p; G2 the twist's 3b' c0 and c1, G1
#                               9b in Montgomery form (C1)
ROWS = 8                      # constant rows: 3 slots, then 5 EXACT slacks
ADD, RESET, DBL, FRESH = range(4)    # the schedules, in table order
ADD_KERNEL = (ADD, RESET)            # K2/K4 run these (K6 ADD), K3/K5 DBL
#                                      and FRESH
N_OUT = 6                            # output slot room per list (header)
KINDS = 3                            # kernel kinds: add, doubling, merge
WIDE, LEVELS, INSTRS = 9, 10, 11     # header words after the layouts,
RANGES, OUTS = 12, 20                # then the ranges and output slots
HDR = OUTS + 3 * N_OUT               # header words of the table
# Lane-team layouts, (threads per team, warps per block) of the add kernel
# (K2/K4), of the doubling kernel (K3/K5) and of the merge kernel (K6) at
# MERGE_WIDE lanes and more (narrower K6 launches take the add's), from
# team_sweep.py on the H100 (PERF.md)
LAYOUT = {"g1": ((6, 4), (3, 2), (3, 2)), "g2": ((8, 2), (8, 2), (8, 2))}
MERGE_WIDE = 8192
KP2 = (0, 2, 4, 16, 32)              # G2 EXACT slacks, multiples of p


class _Prog:
    """A straight-line program over base-field values. A node is an int:
    an input, a constant slot id (>= CONST0) or an instruction. A *sum* is
    (scale, nodes): the lazy value scale * sum(nodes). `kps`: the multiples
    of p that EXACT may add (the slack rows)."""

    def __init__(self, n_in, kps):
        self.n_in = n_in
        self.kps = kps
        self.ins = []                # (kind, dst node, a sum, b sum, kp idx)

    def _emit(self, kind, a, b=(1, ()), kp=0):
        for s in (a, b):
            if len(s[1]) > 4:
                raise ValueError("an operand sums at most four slots")
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
# y, z; 3b a small scale (<= 14) and 9b a product by its Montgomery form
# (9b > 15), BN254's branches (ops/cuda.py _g1_consts checks them)
# ----------------------------------------------------------------------

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
    Zt = _s(t1, pg.lazy(_s(t2, scale=b3)))            # Y1Y2 + 3bZ1Z2
    M = _s(pg.exact(_s(t1), m16, _s(t2, scale=b3)))   # Y1Y2 - 3bZ1Z2
    G = _s(t5, scale=b3)                              # 3b (X1Z2 + X2Z1)
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
    Y3t = _s(t0, pg.lazy(_s(zz, scale=b3)))           # Y^2 + 3b Z^2
    X3 = pg.mul(_s(zz, scale=b3), _s(t0, scale=8))    # 3b Z^2 8 Y^2
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
# G2 (the same formulas over Fp2 = Fp[u]/(u^2 + 1)): Fp2 values are pairs
# of sums (c0, c1); base elements x.c0, x.c1, y.c0, y.c1, z.c0, z.c1
# ----------------------------------------------------------------------

def _f2(c0, c1):
    return (_s(c0), _s(c1))


def _f2_add(A, B):
    return (_cat(A[0], B[0]), _cat(A[1], B[1]))


def _f2_small(A, s):
    return (_scale(A[0], s), _scale(A[1], s))


def _f2_mul(pg, A, B):
    """Fp2.mul: Karatsuba, c0 = v0 + 2p - v1, c1 = t + 4p - (v0 + v1)."""
    v0 = pg.mul(A[0], B[0])
    v1 = pg.mul(A[1], B[1])
    t = pg.mul(_cat(A[0], A[1]), _cat(B[0], B[1]))
    return _f2(pg.exact(_s(v0), 2, _s(v1)), pg.exact(_s(t), 4, _s(v0, v1)))


def _f2_sub(pg, A, B, k):
    return _f2(pg.exact(A[0], k, B[0]), pg.exact(A[1], k, B[1]))


def _f2_fresh(pg, A):
    return [pg.fresh(A[0]), pg.fresh(A[1])]


B3 = _f2(C1, C2)


def _g2_add():
    """Curve._add_plain over Fp2 (RCB15 Alg 7, a = 0), then every output
    component re-reduced."""
    pg = _Prog(12, KP2)
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


def _g2_dbl():
    """The Fp2 branch of Curve._dbl_plain (RCB15 Alg 9, a = 0): X3 = 2 Xa,
    Y3 = Ya + X3', Z3 exact, left in the input slots."""
    pg = _Prog(6, KP2)
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
    out = [pg.lazy(c) for c in Xn + Yn] + [Z3[0][1][0], Z3[1][1][0]]
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


def _levels(pg, team):
    """Place each instruction in a level (product levels even, linear
    levels odd). The depth is the as-soon-as-possible placement's; each
    instruction also has a latest level that keeps that depth. Linear
    instructions go as soon as they can. A product level is opened only
    for the products that cannot wait, and is then filled up to a whole
    number of team rounds (a multiple of `team`) with products that are
    ready, those that must go soonest first. Empty levels go."""
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
        rounds = -(-len(must) // team)
        extra = sorted((n for n in ready if alap[n] > level),
                       key=lambda n: alap[n])
        for n in must + extra[:rounds * team - len(must)]:
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
    """What a group's table depends on: G2's is fixed; G1's takes 3b and
    the lift multiples of the field's lazy subtractions."""
    if G.is_fp2:
        return ("g2",)
    F = G.F
    return ("g1", G._b3_int, F.lift_limbs(16)[1], F.lift_limbs(32)[1])


def _kps(key):
    return KP2 if key[0] == "g2" else (0,) + key[2:]


@functools.lru_cache(maxsize=None)
def _table(key, layout):
    kps = _kps(key)
    if key[0] == "g2":
        progs = (_g2_add(), _g2_reset(), _g2_dbl(), _g2_fresh())
    else:
        _, b3, m16, m32 = key
        progs = (_g1_add(b3, m16, kps), _g1_reset(kps),
                 _g1_dbl(b3, m32, kps), _g1_fresh(kps))
    levels, instrs, ranges, outs = [], [], [], []
    n_slots = [0, 0, 0]
    for sched, (pg, inputs, out, pinned) in enumerate(progs):
        kernel = 0 if sched in ADD_KERNEL else 1
        lv, n_lv = _levels(pg, layout[kernel][0])
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
    words = [v for k in range(KINDS) for v in (*layout[k], n_slots[k])]
    words += [MERGE_WIDE, len(levels), len(instrs)]
    words += [v for r in ranges for v in r] + outs + levels
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
      then one word per level: first instruction | count << 16,
      then three words per instruction:
        kind | dst << 2 | sa << 10 | sb << 16 | na << 22 | nb << 25
             | kp << 28,  a slots (4 x 8 bits),  b slots (4 x 8 bits)."""
    if layout is None:
        layout = LAYOUT["g2" if G.is_fp2 else "g1"]
    return _table(_key(G), tuple(tuple(v) for v in layout))


def _limbs(v, L):
    return [(v >> (16 * i)) & 0xFFFF for i in range(L)]


def rows(G):
    """The constant rows the instructions read, ROWS x L uint32 words:
    slots ONE, C1, C2 (G2: R mod p, 3b' c0, 3b' c1; G1: R mod p, 9b in
    Montgomery form, 0), then the exact 16-bit limbs of m p for each EXACT
    slack index (zero rows past the group's)."""
    B = G.F.base if G.is_fp2 else G.F
    L, p = B.L, B.modulus
    one = list(B.params.one_limbs)
    if G.is_fp2:
        b3 = G._b3.cpu().tolist()                # (2, L) Montgomery limbs
        cst = [one, b3[0], b3[1]]
    else:
        m9 = 3 * G._b3_int * B.params.mont_r % p
        cst = [one, _limbs(m9, L), [0] * L]
    slack = [_limbs(m * p, L) for m in _kps(_key(G))]
    slack += [[0] * L] * (ROWS - 3 - len(slack))
    return [int(v) for r in cst + slack for v in r]


def block(G, layout=None):
    """What the kernels of G's group read behind its constants: rows(G),
    then table(G, layout)."""
    return rows(G) + list(table(G, layout))


def rounds(words):
    """Product rounds of a team per schedule (ADD, RESET, DBL, FRESH): sum
    over its product levels of ceil(products / threads per team)."""
    ranges, _, lv, ins = _decode(words)
    teams = [words[0 if s in ADD_KERNEL else 3] for s in range(4)]
    return [sum(-(-(w >> 16) // team) for w in lv[slice(*r)]
                if ins[3 * (w & 0xFFFF)] & 3 == MUL)
            for r, team in zip(ranges, teams)]


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


def run(F, blk, sched, slots, stats=None):
    """Execute schedule `sched` of the block `blk` (rows, then table) over
    `slots` (a list of (L, *batch) limb tensors of the base field F, at
    least the schedule's inputs filled) with F's plain ops, as the kernel
    does, in place. With `stats` (a dict), record the bounds of every
    product's inputs (bound_stats). Returns `slots`."""
    L = F.L
    words = blk[ROWS * L:]
    ranges, _, lv, ins = _decode(words)
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
                res.append((dst, F._mul_plain(a, b)))
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


def plain_add(G, P, Q, reset=None, blk=None, stats=None):
    """K2's (G1) or K4's (G2) schedules run by `run` on point dicts of the
    base field's device: reset ? Q re-reduced : P + Q, every output
    re-reduced. blk: the block to run (default block(G))."""
    B = G.F.base if G.is_fp2 else G.F
    blk = block(G) if blk is None else blk
    words = blk[ROWS * B.L:]
    P, Q = [{k: v.expand(torch.broadcast_shapes(P[k].shape, Q[k].shape))
             for k, v in X.items()} for X in (P, Q)]
    n = 6 if G.is_fp2 else 3
    slots = run(B, blk, ADD, _split(G, P) + _split(G, Q), stats)
    out = _join(G, [slots[s] for s in _out(ADD, words, n)])
    if reset is not None:
        slots = run(B, blk, RESET, [None] * n + _split(G, Q), stats)
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


def plain_merge(G, aL, aR, bL, bR, fuse, asing, bsing, blk=None):
    """K6's program: the add's schedule over (aR, bL) by `run` gives mid;
    newL = (fuse & asing) ? mid : aL, newR = (fuse & bsing) ? mid : bR,
    the kept lanes' limbs unchanged."""
    mid = plain_add(G, aR, bL, blk=blk)
    newL = G.select(torch.logical_and(fuse, asing), mid, aL)
    newR = G.select(torch.logical_and(fuse, bsing), mid, bR)
    return mid, newL, newR
