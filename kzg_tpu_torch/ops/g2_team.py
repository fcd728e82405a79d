"""Schedules of the G2 lane-team kernels K4 (complete add) and K5 (doubling
chain), as data.

K4 and K5 (csrc/g2_team.cuh) give each lane of a G2 point batch to a team
of threads inside one warp. The point, the constants and every
intermediate live in the block's shared memory as base-field *slots* (17
uint32 limbs each); the formula runs in *levels*. In a level every
instruction is independent of the others, team rank r executes
instructions r, r + T, r + 2T, ... (T threads per team), and the team
synchronises after it. An instruction is one of

  MUL    dst = (sa * sum(a)) (sb * sum(b)) R^-1   (one Montgomery product)
  LAZY   dst = sa * sum(a)                        (limbwise, no carries)
  EXACT  dst = sa * sum(a) + k p - sb * sum(b)    (exact 16-bit limbs)

over up to four operand slots a and b each. Folding lazy sums and small
scales into operands keeps the values and limbs of the plain versions
(Curve._add_plain and the Fp2 branch of Curve._dbl_plain over Fp2.mul,
Fp2.add, Fp2.sub(k) and mul_small): a lazy add is a limbwise sum in either
place, and an exact subtraction's limbs are the unique 16-bit limbs of its
value. Nothing is reordered across a subtraction, so every Montgomery
product sees the operands the plain version gives Field.mul.

This module builds the four schedules (the add, the add of a reset lane,
one doubling, the re-reduction after a chain), places each level's
instructions, allocates slots by liveness, and encodes all of it as the
uint32 words that ops/cuda.py appends to the G2 constant block. The kernel
executes those words; ``run`` executes the same words with the base
field's plain ops, which the CPU tests hold against the plain versions.
"""

from __future__ import annotations

import functools

import torch

MUL, LAZY, EXACT = 0, 1, 2
CONST0 = 240                         # slot ids >= CONST0 are constants:
ONE, B3C0, B3C1 = 240, 241, 242      # R mod p, the twist's 3b' c0 and c1
KP = (0, 2, 4, 16, 32)               # EXACT slack index -> multiple of p
ADD, RESET, DBL, FRESH = range(4)    # the schedules, in table order
N_OUT = 6                            # output slots of ADD, RESET, FRESH
# fixed input slots: ADD reads P in 0-5 and Q in 6-11 (x.c0, x.c1, y.c0,
# y.c1, z.c0, z.c1), RESET reads Q in 6-11, DBL and FRESH read 0-5; DBL
# leaves its result in 0-5 for the next doubling
IN_P, IN_Q = tuple(range(6)), tuple(range(6, 12))
TEAM = 8                             # threads per lane team (PERF.md)
WARPS = 2                            # warps per block
HDR = 31                             # header words of the table


class _Prog:
    """A straight-line program over base-field values. A node is an int:
    an input, a constant slot id (>= CONST0) or an instruction. A *sum* is
    (scale, nodes): the lazy value scale * sum(nodes)."""

    def __init__(self, n_in):
        self.n_in = n_in
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

    def exact(self, a, k, b):
        return self._emit(EXACT, a, b, KP.index(k))


def _s(*nodes, scale=1):
    return (scale, tuple(nodes))


def _cat(x, y):
    """Lazy sum of two sums of the same scale."""
    if x[0] != y[0]:
        raise ValueError("lazy sums of different scales")
    return (x[0], x[1] + y[1])


def _scale(x, s):
    return (x[0] * s, x[1])


# Fp2 values are pairs of sums (c0, c1); qnr = -1 as for BN254.

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


def _fresh(pg, A):
    return [pg.mul(A[0], _s(ONE)), pg.mul(A[1], _s(ONE))]


B3 = _f2(B3C0, B3C1)


def _add_prog():
    """Curve._add_plain over Fp2 (RCB15 Alg 7, a = 0), then every output
    component re-reduced (times Montgomery 1)."""
    pg = _Prog(12)
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
    out = _fresh(pg, X3) + _fresh(pg, Y3) + _fresh(pg, Z3)
    return pg, IN_P + IN_Q, out, {}


def _reset_prog():
    """A reset lane's output: Q re-reduced."""
    pg = _Prog(12)
    out = []
    for c in range(3):
        out += _fresh(pg, _f2(6 + 2 * c, 7 + 2 * c))
    return pg, IN_Q, out, {}


def _dbl_prog():
    """The Fp2 branch of Curve._dbl_plain (RCB15 Alg 9, a = 0): X3 = 2 Xa,
    Y3 = Ya + X3', Z3 exact, left in the input slots."""
    pg = _Prog(6)
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
    return pg, IN_P, out, {n: i for i, n in enumerate(out)}


def _fresh_prog():
    """The end of a chain: the point in 0-5 re-reduced."""
    pg = _Prog(6)
    out = []
    for c in range(3):
        out += _fresh(pg, _f2(2 * c, 2 * c + 1))
    return pg, IN_P, out, {}


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


@functools.lru_cache(maxsize=None)
def table(team=TEAM, warps=WARPS):
    """The encoded schedules for teams of `team` threads and blocks of
    `warps` warps, uint32 words:
      [0] threads per team, [1] warps per block, [2] slots per lane,
      [3] levels, [4] instructions,
      [5 + 2 s], [6 + 2 s]: first and end level of schedule s (ADD, RESET,
          DBL, FRESH),
      [13 ...]: the output slots of ADD, RESET and FRESH (6 each),
      then one word per level: first instruction | count << 16,
      then three words per instruction:
        kind | dst << 2 | sa << 10 | sb << 16 | na << 22 | nb << 25
             | kp << 28,  a slots (4 x 8 bits),  b slots (4 x 8 bits)."""
    levels, instrs, ranges, outs = [], [], [], []
    n_slots = 12
    for build in (_add_prog, _reset_prog, _dbl_prog, _fresh_prog):
        pg, inputs, out, pinned = build()
        lv, n_lv = _levels(pg, team)
        slot = _alloc(pg, inputs, out, pinned, lv, n_lv)
        n_slots = max(n_slots, 1 + max(slot.values()))
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
        if build is not _dbl_prog:
            outs += [slot[n] for n in out]
    words = [team, warps, n_slots, len(levels), len(instrs)]
    words += [v for r in ranges for v in r] + outs + levels
    words += [w for ins in instrs for w in ins]
    return tuple(words)


def rounds(words=None):
    """Product rounds of a team per schedule: sum over its product levels
    of ceil(products / threads per team)."""
    words = table() if words is None else words
    team = words[0]
    _, ranges, _, lv, ins = _decode(words)
    return [sum(-(-(w >> 16) // team) for w in lv[slice(*r)]
                if ins[3 * (w & 0xFFFF)] & 3 == MUL) for r in ranges]


# ----------------------------------------------------------------------
# the plain interpreter of the table (the kernel's executor, in PyTorch)
# ----------------------------------------------------------------------

def _decode(words):
    n_slots, n_lv, n_ins = words[2:5]
    ranges = [tuple(words[5 + 2 * s:7 + 2 * s]) for s in range(4)]
    outs = [list(words[13 + N_OUT * i:13 + N_OUT * (i + 1)])
            for i in range(3)]
    base = HDR
    lv = words[base:base + n_lv]
    ins = words[base + n_lv:base + n_lv + 3 * n_ins]
    return n_slots, ranges, outs, lv, ins


def _operand(slots, consts, scale, n, word):
    v = None
    for q in range(n):
        s = (word >> (8 * q)) & 0xFF
        x = consts[s - CONST0] if s >= CONST0 else slots[s]
        v = x if v is None else v + x
    return v * scale


def run(F, consts, sched, slots, words=None, stats=None):
    """Execute schedule `sched` of the table over `slots` (a list of
    (L, *batch) limb tensors of the base field F, at least the schedule's
    inputs filled) with F's plain ops, as the kernel does, in place.
    consts: the (L,) tensors of ONE, 3b' c0, 3b' c1. With `stats` (a dict),
    record the largest value / p and the largest limb of any product
    input. Returns `slots`."""
    words = table() if words is None else words
    n_slots, ranges, _, lv, ins = _decode(words)
    slots.extend([None] * (n_slots - len(slots)))
    p = F.modulus
    for level in range(*ranges[sched]):
        first, count = lv[level] & 0xFFFF, lv[level] >> 16
        res = []
        for i in range(first, first + count):
            w0, wa, wb = ins[3 * i:3 * i + 3]
            kind, dst = w0 & 3, (w0 >> 2) & 0xFF
            sa, sb = (w0 >> 10) & 63, (w0 >> 16) & 63
            na, nb, kp = (w0 >> 22) & 7, (w0 >> 25) & 7, (w0 >> 28) & 7
            a = _operand(slots, consts, sa, na, wa)
            if kind == LAZY:
                res.append((dst, a))
                continue
            b = _operand(slots, consts, sb, nb, wb)
            if kind == MUL:
                if stats is not None:
                    _bound_stats(stats, (a, b), p)
                res.append((dst, F._mul_plain(*F._bc(a, b))))
                continue
            t = F._norm16(a + F._col(F._kp_limbs(KP[kp]), a.ndim - 1))
            d, ok = F._sub_chain(list(t), list(F._norm16(b)))
            if not bool(torch.all(ok == 1)):
                raise ArithmeticError("exact subtraction went negative")
            res.append((dst, torch.stack(d, dim=0)))
        for dst, v in res:           # the level's writes land after its reads
            slots[dst] = v
    return slots


def _bound_stats(stats, xs, p):
    """Largest limb and value / p (in float64, ample for a bound of 64) of
    the product inputs xs."""
    for x in xs:
        flat = x.reshape(x.shape[0], -1)
        stats["limb"] = max(stats.get("limb", 0), int(flat.max()))
        w = torch.tensor([2.0 ** (16 * k) for k in range(x.shape[0])],
                         dtype=torch.float64)
        v = float((flat.double() * w[:, None]).sum(0).max())
        stats["value_over_p"] = max(stats.get("value_over_p", 0.0), v / p)


def outputs(sched, words=None):
    """The output slots of ADD, RESET or FRESH (DBL: its inputs)."""
    words = table() if words is None else words
    if sched == DBL:
        return list(IN_P)
    return _decode(words)[2][(ADD, RESET, FRESH).index(sched)]


def _consts(G, ndim):
    B = G.F.base
    shape = (B.L,) + (1,) * (ndim - 1)
    return [B.one_mont.reshape(shape), G._b3[0].reshape(shape),
            G._b3[1].reshape(shape)]


def _split(P):
    return [P[k][c] for k in ("x", "y", "z") for c in (0, 1)]


def _join(vals):
    return {k: torch.stack(vals[2 * i:2 * i + 2], dim=0)
            for i, k in enumerate(("x", "y", "z"))}


def plain_add(G, P, Q, reset=None, words=None, stats=None):
    """K4's schedules run by `run` on G2 point dicts of the base field's
    device: reset ? Q re-reduced : P + Q, every output re-reduced."""
    B = G.F.base
    P, Q = [{k: v.expand(torch.broadcast_shapes(P[k].shape, Q[k].shape))
             for k, v in X.items()} for X in (P, Q)]
    cs = _consts(G, P["x"].ndim - 1)
    slots = run(B, cs, ADD, _split(P) + _split(Q), words, stats)
    out = _join([slots[s] for s in outputs(ADD, words)])
    if reset is not None:
        slots = run(B, cs, RESET, [None] * 6 + _split(Q), words, stats)
        out = G.select(reset, _join([slots[s] for s in outputs(RESET,
                                                               words)]), out)
    return out


def plain_dbl(G, P, times, words=None, stats=None):
    """K5's schedules: `times` doublings, then the re-reduction."""
    B = G.F.base
    cs = _consts(G, P["x"].ndim - 1)
    slots = _split(P)
    for _ in range(times):
        slots = run(B, cs, DBL, slots, words, stats)
    slots = run(B, cs, FRESH, slots, words, stats)
    return _join([slots[s] for s in outputs(FRESH, words)])
