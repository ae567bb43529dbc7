"""K13's point formulas as programs of field operations.

K13's tree reduce (csrc/msm_kernels_n.cuh) adds and doubles points of the
other curves' six types (bls12-377 and bls12-381 G1 over a 12-word Fq,
their G2 over Fq2, bw6-761 G1 and G2 over a 24-word Fq) by walking a
program: a list of steps, each

    dst = (a1 [+ a2]) OP (b1 [+ b2]),   OP one of *, +, -

over one Fq word vector a step, with the operands in the thread's slots of
shared memory. A step holds one Montgomery product or one addition, so the
kernel holds one inlined copy of the product however many the formula
needs (12 to 42 for a complete add), and no point lives in registers.

This module writes the RCB15 formulas of csrc/curve.cuh (`p_add_inl` alg
7, `p_dbl` alg 9; the same polynomials as curve/jcurve.py `padd` and
`pdbl`, so every result is the plain versions' word for word) as such
programs for a `PointGroup`, allocates the slots (inputs and outputs at
fixed slots, temporaries in the lowest free one, slots [6C, 9C) left to
the kernel), and encodes them for the kernel: two 32-bit words a step,

    w0 = op | dst << 8 | a1 << 16 | b1 << 24,   w1 = a2 | b2 << 8,

an operand below CONST a slot, CONST + k the table's constant k, NONE no
term. Fq2 values are pairs of Fq values (Karatsuba, as curves/device.py
`LimbFq2Ops.mul_many`); small constants multiply by addition chains.
`run_program` interprets a program over Python integers: the tests hold it
against the plain point formulas.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

OP_MUL, OP_ADD, OP_SUB = 0, 1, 2
CONST = 0xF0
NONE = 0xFF

# The programs of a group, in the order of the table (csrc/msm_kernels_n.cuh
# PROG_*): the complete add P = P + Q and the doubling P = 2 P.
ADD, DBL = range(2)
N_PROGRAMS = 2


class _Builder:
    """Fq-level steps over value ids; constants are ("c", k)."""

    def __init__(self):
        self.steps = []  # (op, dst, a1, a2, b1, b2)
        self.n_vals = 0

    def new(self):
        self.n_vals += 1
        return self.n_vals - 1

    def step(self, op, a1, b1, a2=None, b2=None):
        d = self.new()
        self.steps.append((op, d, a1, a2, b1, b2))
        return d


ZERO = ("c", 0)


def _small(b: _Builder, x, k: int):
    """k * x for a small signed k: doublings, the set bits added on the way,
    the last doubling and addition one step; negated for k < 0."""
    a = abs(k)
    if a == 1:
        r = x
    else:
        top = a.bit_length() - 1
        acc, cur = None, x  # cur = 2^i x
        for i in range(top):
            if a >> i & 1:
                acc = cur if acc is None else b.step(OP_ADD, acc, cur)
            if i < top - 1:
                cur = b.step(OP_ADD, cur, cur)
        r = b.step(OP_ADD, cur, cur) if acc is None else b.step(OP_ADD, cur, acc, cur)
    return b.step(OP_SUB, ZERO, r) if k < 0 else r


class _Fq:
    """Fq coordinates: a value is one Fq value id. b3 is a small signed
    integer (an addition chain) or constant 1 (a product)."""

    def __init__(self, b: _Builder, b3_small):
        self.b, self.b3_small = b, b3_small

    def mul(self, x, y):
        return self.b.step(OP_MUL, x, y)

    def mul_s(self, x1, x2, y1, y2):
        """(x1 + x2) (y1 + y2)"""
        return self.b.step(OP_MUL, x1, y1, x2, y2)

    def add(self, x, y):
        return self.b.step(OP_ADD, x, y)

    def sub(self, x, y, y2=None):
        """x - (y + y2)"""
        return self.b.step(OP_SUB, x, y, None, y2)

    def triple(self, x):
        return self.b.step(OP_ADD, x, x, x)

    def mul_b3(self, x):
        if self.b3_small is not None:
            return _small(self.b, x, self.b3_small)
        return self.mul(("c", 1), x)


class _Fq2:
    """Fq2 = Fq[u] / (u^2 - nr) coordinates: a value is a pair (c0, c1).
    b3 = (b0, b1): small signed integers, or constants 1 and 2."""

    def __init__(self, b: _Builder, nr: int, b3):
        self.b, self.nr, self.b3 = b, nr, b3

    def _karatsuba(self, x0, x1, y0, y1, x0b=None, x1b=None, y0b=None, y1b=None):
        """(x + xb)(y + yb): T0 + nr T1 + (T2 - T0 - T1) u"""
        b = self.b
        t0 = b.step(OP_MUL, x0, y0, x0b, y0b)
        t1 = b.step(OP_MUL, x1, y1, x1b, y1b)
        sx = b.step(OP_ADD, x0, x1, x0b, x1b)
        sy = b.step(OP_ADD, y0, y1, y0b, y1b)
        t2 = b.step(OP_MUL, sx, sy)
        if self.nr == -1:
            c0 = b.step(OP_SUB, t0, t1)
        else:
            c0 = b.step(OP_SUB if self.nr < 0 else OP_ADD, t0, _small(b, t1, abs(self.nr)))
        return c0, b.step(OP_SUB, t2, t0, None, t1)

    def mul(self, x, y):
        return self._karatsuba(x[0], x[1], y[0], y[1])

    def mul_s(self, x1, x2, y1, y2):
        return self._karatsuba(x1[0], x1[1], y1[0], y1[1], x2[0], x2[1], y2[0], y2[1])

    def add(self, x, y):
        return tuple(self.b.step(OP_ADD, x[i], y[i]) for i in range(2))

    def sub(self, x, y, y2=None):
        return tuple(self.b.step(OP_SUB, x[i], y[i], None, y2 and y2[i]) for i in range(2))

    def triple(self, x):
        return tuple(self.b.step(OP_ADD, c, c, c) for c in x)

    def mul_b3(self, x):
        """(b0 + b1 u)(x0 + x1 u), each b a small chain or a product by a
        constant."""
        s0, s1 = self.b3
        x0, x1 = x

        def times(k, s, v):
            return _small(self.b, v, s) if s is not None else self.b.step(OP_MUL, ("c", k), v)

        if s0 == 0:
            # (b1 u)(x0 + x1 u) = nr b1 x1 + b1 x0 u
            return _small(self.b, times(2, s1, x1), self.nr), times(2, s1, x0)
        if s0 is not None and s0 == s1 and self.nr == -1:
            # k (1 + u)(x0 + x1 u) = k (x0 - x1) + k (x0 + x1) u
            return (_small(self.b, self.b.step(OP_SUB, x0, x1), s0),
                    _small(self.b, self.b.step(OP_ADD, x0, x1), s0))
        return self._karatsuba(("c", 1), ("c", 2), x0, x1)


def _tail(E, t3, t4, z3, x3m, t0, y3m):
    """The last products of alg 7: X3 = t3 x3m - t4 y3m, Y3 = x3m z3 + t0
    y3m, Z3 = t4 z3 + t3 t0."""
    m1 = E.mul(t4, y3m)
    m2 = E.mul(t0, y3m)
    y3 = E.add(E.mul(x3m, z3), m2)
    x3 = E.sub(E.mul(t3, x3m), m1)
    z3 = E.add(E.mul(t4, z3), E.mul(t3, t0))
    return x3, y3, z3


def _add(E, X1, Y1, Z1, X2, Y2, Z2):
    """RCB15 alg 7, csrc/curve.cuh p_add_inl."""
    t0 = E.mul(X1, X2)
    t1 = E.mul(Y1, Y2)
    t3 = E.sub(E.mul_s(X1, Y1, X2, Y2), t0, t1)
    t2 = E.mul(Z1, Z2)
    t4 = E.sub(E.mul_s(Y1, Z1, Y2, Z2), t1, t2)
    t5 = E.sub(E.mul_s(X1, Z1, X2, Z2), t0, t2)
    u = E.mul_b3(t2)
    y3m = E.mul_b3(t5)
    z3 = E.add(t1, u)
    x3m = E.sub(t1, u)
    t0 = E.triple(t0)
    return _tail(E, t3, t4, z3, x3m, t0, y3m)


def _dbl(E, X, Y, Z):
    """RCB15 alg 9, csrc/curve.cuh p_dbl."""
    t0 = E.mul(Y, Y)
    t1 = E.mul(Y, Z)
    t2 = E.mul(Z, Z)
    txy = E.mul(X, Y)
    z3a = E.add(t0, t0)
    z3a = E.add(z3a, z3a)
    z3a = E.add(z3a, z3a)
    t2b = E.mul_b3(t2)
    y3s = E.add(t0, t2b)
    t0b = E.sub(t0, E.triple(t2b))
    mxf = E.mul(t0b, txy)
    z3 = E.mul(t1, z3a)
    y3 = E.add(E.mul(t2b, z3a), E.mul(t0b, y3s))
    return E.add(mxf, mxf), y3, z3


def _flat(v):
    return list(v) if isinstance(v, tuple) else [v]


def _allocate(steps, inputs: dict, outputs: dict, reserved: set) -> tuple:
    """Slots for every value: inputs and outputs at their given slots, other
    values in the lowest slot that is free from their step to their last use,
    outside `reserved` and not needed by a later output's pinned slot before
    then. An operand's last use and the result of the same step may share a
    slot (a step reads all its operands before it writes). Returns (slot of
    each value, slots used)."""
    end = len(steps)
    last = {}
    for t, (_op, _d, *srcs) in enumerate(steps):
        for s in srcs:
            if s is not None and not isinstance(s, tuple):
                last[s] = t
    for v in outputs:
        last[v] = end
    out_def = {outputs[d]: t for t, (_op, d, *_s) in enumerate(steps) if d in outputs}
    slot = dict(inputs)
    busy = {s: last.get(v, -1) for v, s in inputs.items()}  # slot -> last use of its value
    for t, (_op, d, *_s) in enumerate(steps):
        if d in outputs:
            s = outputs[d]
            if busy.get(s, -1) > t:
                raise ValueError(f"output slot {s} still holds a live value at step {t}")
        else:
            lu = last.get(d, t)
            s = 0
            while busy.get(s, -1) > t or s in reserved or t < out_def.get(s, -1) < lu:
                s += 1
        slot[d] = s
        busy[s] = last.get(d, t)
    return slot, max(list(slot.values()) + list(reserved)) + 1


@dataclass(frozen=True)
class GroupPrograms:
    """The encoded programs of one PointGroup."""

    table: tuple  # constants (n_consts x words), then every program's words
    first: tuple  # first step of each program
    count: tuple  # steps of each program
    n_consts: int
    slots: int  # slots a thread uses, of one Fq value each
    width: int  # Fq values a coordinate: 1 (Fq) or 2 (Fq2)
    words: int

    def meta(self) -> list:
        """The C entry's integer arguments: first[2], count[2], steps,
        constants, slots."""
        return [*self.first, *self.count, sum(self.count), self.n_consts, self.slots]

    def steps(self, prog: int) -> list:
        """Program `prog` as (op, dst, a1, a2, b1, b2) tuples."""
        w = self.table[self.n_consts * self.words:]
        out = []
        for i in range(self.first[prog], self.first[prog] + self.count[prog]):
            w0, w1 = w[2 * i] & 0xFFFFFFFF, w[2 * i + 1] & 0xFFFFFFFF
            out.append((w0 & 0xFF, (w0 >> 8) & 0xFF, (w0 >> 16) & 0xFF, w1 & 0xFF,
                        w0 >> 24, (w1 >> 8) & 0xFF))
        return out


def build_programs(group) -> GroupPrograms:
    """The programs of a K13 PointGroup (curve >= 0), slots allocated and
    encoded. The constants: 0, then b3 in Montgomery form (two for Fq2)."""
    from ..curves.device import _small_signed  # curves/device.py imports this package

    plain = group.plain
    spec = plain.spec
    q, r = spec.modulus, spec.r_mod
    width = 2 if getattr(plain, "g2", False) else 1
    if width == 2:
        if plain._nr_small is None:
            raise ValueError("K13 programs: an Fq2 non-residue must be a small integer")
        b3 = plain._b3_val
    else:
        b3 = (plain._b3_int,)
    consts = [0, *(v * r % q for v in b3)]
    small = tuple(_small_signed(v, q) for v in b3)
    progs = []
    for kind in range(N_PROGRAMS):
        b = _Builder()
        E = _Fq(b, small[0]) if width == 1 else _Fq2(b, plain._nr_small, small)

        def point():
            return tuple(b.new() if width == 1 else (b.new(), b.new()) for _ in range(3))

        def pin(vals, base):
            return {v: base + i for i, v in enumerate(x for c in vals for x in _flat(c))}

        c3 = 3 * width
        p = point()
        inputs = pin(p, 0)
        if kind == ADD:
            qpt = point()
            inputs.update(pin(qpt, c3))
            res = _add(E, *p, *qpt)
        else:
            res = _dbl(E, *p)
        slot, used = _allocate(b.steps, inputs, pin(res, 0), set(range(2 * c3, 3 * c3)))

        def enc(v):
            if v is None:
                return NONE
            return CONST + v[1] if isinstance(v, tuple) else slot[v]

        words = []
        for op, d, a1, a2, b1, b2 in b.steps:
            words += [op | slot[d] << 8 | enc(a1) << 16 | enc(b1) << 24, enc(a2) | enc(b2) << 8]
        progs.append((words, used))
    if max(u for _, u in progs) >= CONST:
        raise ValueError("K13 programs: too many slots")
    n = spec.words
    table = [(v >> (32 * k)) & 0xFFFFFFFF for v in consts for k in range(n)]
    first, count = [], []
    for words, _ in progs:
        first.append(sum(count))
        count.append(len(words) // 2)
        table += words
    table = tuple(w - (1 << 32) if w >= 1 << 31 else w for w in table)
    return GroupPrograms(table=table, first=tuple(first), count=tuple(count),
                         n_consts=len(consts), slots=max(u for _, u in progs), width=width,
                         words=n)


_CACHE: dict = {}


def group_programs(group) -> GroupPrograms:
    """build_programs, once per group."""
    if group.name not in _CACHE:
        _CACHE[group.name] = build_programs(group)
    return _CACHE[group.name]


def program_table(group, device) -> torch.Tensor:
    """The group's table as an int32 tensor on `device` (once per device)."""
    key = (group.name, str(device))
    if key not in _CACHE:
        _CACHE[key] = torch.tensor(group_programs(group).table, dtype=torch.int32,
                                   device=device)
    return _CACHE[key]


def run_program(gp: GroupPrograms, prog: int, slots: list, modulus: int) -> list:
    """Interpret program `prog` over Python integers in Montgomery form (the
    product is a * b / 2^(32 words) mod p), in place on `slots` (extended to
    the group's slots). Returns slots."""
    n = gp.words
    rinv = pow(1 << (32 * n), -1, modulus)
    consts = [sum((gp.table[k * n + j] & 0xFFFFFFFF) << (32 * j) for j in range(n))
              for k in range(gp.n_consts)]
    slots += [0] * (gp.slots - len(slots))

    def val(s):
        return consts[s - CONST] if s >= CONST else slots[s]

    for op, d, a1, a2, b1, b2 in gp.steps(prog):
        a = val(a1) + (val(a2) if a2 != NONE else 0)
        b = val(b1) + (val(b2) if b2 != NONE else 0)
        slots[d] = (a * b * rinv if op == OP_MUL else a + b if op == OP_ADD else a - b) % modulus
    return slots
