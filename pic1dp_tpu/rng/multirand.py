"""multirand-compatible pseudo-random number generators.

Reproduces, bit-exactly, the three 64-bit engines of the reference's
`multirand` module (reference src/multirand.F90): Marsaglia's 64-bit KISS
(:921-945), 64-bit Mersenne Twister 19937 (:952-997), and Marsaglia's 64-bit
SuperKISS (:1004-1039), together with its seeding schemes (:244-351), warm-up
(:373-381), known-answer self-test (:390-553), uniform [0, 1] conversion
(macros :49-50) and Gaussian generation via the Marsaglia polar method with a
carry buffer (:784-914).

Purpose: "deterministic multirand-compatible particle loading" — a
constant-seed run of this framework loads marker-for-marker the same
particles as the Fortran reference, so physics trajectories can be compared
directly (see BASELINE.json north_star).

The engines are sequential by construction; this pure-Python/numpy version is
the correctness reference and the self-test oracle.  A C++ implementation
(pic1dp_tpu/rng/native) provides the fast path for multi-million-marker
loading, validated against this module in tests.

All arithmetic is modulo 2^64 (numpy uint64 / Python ints masked); Fortran's
ishft is a logical shift, so signed Fortran integers and uint64 agree on
every operation used.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np

M64 = (1 << 64) - 1
MAX_I64 = float((1 << 63) - 1)          # multirand_max64 (:73-75)
MAX_U64 = float((1 << 64) - 1)          # multirand_maxu64 (:76-78)
MAX_I32 = np.float32(2147483647.0)      # multirand_max32 (:78)
MAX_U32 = np.float32(4294967295.0)      # multirand_maxu32 (:80)


def _i32(x: int) -> int:
    """Reinterpret the low 32 bits as a signed int32 (Fortran int(..., mrki32))."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x

# prime tables (reference src/multirand.F90:170-205)
_PRIMES1 = [
    15484219, 15484223, 15484243, 15484247, 15484279,
    15484333, 15484363, 15484387, 15484393, 15484409,
    15484421, 15484453, 15484457, 15484459, 15484471,
    15484489, 15484517, 15484519, 15484549, 15484559,
    15484591, 15484627, 15484631, 15484643, 15484661,
    15484697, 15484709, 15484723, 15484769, 15484771,
    15484783, 15484817, 15484823, 15484873, 15484877,
    15484879, 15484901, 15484919, 15484939, 15484951,
    15484961, 15484999, 15485039, 15485053, 15485059,
    15485077, 15485083, 15485143, 15485161, 15485179,
    15485191, 15485221, 15485243, 15485251, 15485257,
    15485273, 15485287, 15485291, 15485293, 15485299,
    15485311, 15485321, 15485339, 15485341, 15485357,
    15485363, 15485383, 15485389, 15485401, 15485411,
    15485429, 15485441, 15485447, 15485471, 15485473,
    15485497, 15485537, 15485539, 15485543, 15485549,
    15485557, 15485567, 15485581, 15485609, 15485611,
    15485621, 15485651, 15485653, 15485669, 15485677,
    15485689, 15485711, 15485737, 15485747, 15485761,
    15485773, 15485783, 15485801, 15485807, 15485837,
]
_PRIMES2 = [
    7001, 7013, 7019, 7027, 7039, 7043, 7057, 7069, 7079, 7103,
    7109, 7121, 7127, 7129, 7151, 7159, 7177, 7187, 7193, 7207,
    7211, 7213, 7219, 7229, 7237, 7243, 7247, 7253, 7283, 7297,
    7307, 7309, 7321, 7331, 7333, 7349, 7351, 7369, 7393, 7411,
    7417, 7433, 7451, 7457, 7459, 7477, 7481, 7487, 7489, 7499,
    7507, 7517, 7523, 7529, 7537, 7541, 7547, 7549, 7559, 7561,
    7573, 7577, 7583, 7589, 7591, 7603, 7607, 7621, 7639, 7643,
    7649, 7669, 7673, 7681, 7687, 7691, 7699, 7703, 7717, 7723,
    7727, 7741, 7753, 7757, 7759, 7789, 7793, 7817, 7823, 7829,
    7841, 7853, 7867, 7873, 7877, 7879, 7883, 7901, 7907, 7919,
]

NSEED = {1: 4, 2: 312, 3: 20635}   # KISS64 / MT19937-64 / SuperKISS64


def _u(x: int) -> int:
    return x & M64


def _signed(x: int) -> int:
    x &= M64
    return x - (1 << 64) if x >= (1 << 63) else x


def _fmod(a: int, b: int) -> int:
    """Fortran mod() for integers: result has the sign of a (truncated)."""
    r = abs(a) % abs(b)
    return -r if a < 0 else r


class MultiRand:
    """One engine instance == one MPI rank's multirand state."""

    def __init__(self, algorithm: int = 3, seed_type: int = 1,
                 mype: int | None = None, warmup: int = 5,
                 selftest: bool = False):
        if algorithm not in (1, 2, 3):
            raise ValueError("algorithm must be 1 (KISS64), 2 (MT19937-64), or 3 (SuperKISS64)")
        self.algorithm = algorithm
        self.nseed = NSEED[algorithm]
        self.seeds = [0] * 20635
        self.iseed = 0
        self._int32_buf: int | None = None
        self._gauss_buf: float | None = None
        self._gauss32_buf: np.float32 | None = None
        if selftest:
            errors = self.selftest()
            if errors:
                raise AssertionError("multirand selftest failed: " + "; ".join(errors))
        self._init_seeds(seed_type, mype)
        # warm up (reference :373-381)
        for _ in range(warmup * self.nseed):
            self.int64()

    # ---- engines ----

    def _kiss64_raw(self, s: list[int]) -> int:
        """KISS64 step on a 4-element state list (reference :921-945)."""
        x, y, z, c = s[0], s[1], s[2], s[3]
        t = _u((x << 58) + c)
        if (x >> 63) == (t >> 63):
            c_new = _u((x >> 6) + (x >> 63))
        else:
            c_new = _u((x >> 6) - (_u(x + t) >> 63) + 1)
        x = _u(x + t)
        y = _u(y ^ (y << 13))
        y = y ^ (y >> 17)
        y = _u(y ^ (y << 43))
        z = _u(6906969069 * z + 1234567)
        s[0], s[1], s[2], s[3] = x, y, z, c_new
        return _u(x + y + z)

    def _mt19937_64(self) -> int:
        """64-bit Mersenne Twister (reference :952-997)."""
        NN, MM = 312, 156
        UM = 0xFFFFFFFF80000000
        LM = 0x000000007FFFFFFF
        MAG = (0, 0xB5026F5AA96619E9)
        s = self.seeds
        if self.iseed >= NN:
            for i in range(NN - MM):
                x = (s[i] & UM) | (s[i + 1] & LM)
                s[i] = s[i + MM] ^ (x >> 1) ^ MAG[x & 1]
            for i in range(NN - MM, NN - 1):
                x = (s[i] & UM) | (s[i + 1] & LM)
                s[i] = s[i + MM - NN] ^ (x >> 1) ^ MAG[x & 1]
            x = (s[NN - 1] & UM) | (s[0] & LM)
            s[NN - 1] = s[MM - 1] ^ (x >> 1) ^ MAG[x & 1]
            self.iseed = 0
        x = s[self.iseed]
        x ^= (x >> 29) & 0x5555555555555555
        x = _u(x ^ ((x << 17) & 0x71D67FFFEDA60000))
        x = _u(x ^ ((x << 37) & 0xFFF7EEE000000000))
        x ^= x >> 43
        self.iseed += 1
        return x

    def _superkiss64(self) -> int:
        """SuperKISS64 (reference :1004-1039)."""
        NN = 20632
        ICARRY, IXCNG, IXS = NN, NN + 1, NN + 2
        s = self.seeds
        if self.iseed >= NN:
            carry = s[ICARRY]
            for i in range(NN):
                q = s[i]
                h = carry & 1
                z = _u((_u(q << 41) >> 1) + (_u(q << 39) >> 1) + (carry >> 1))
                carry = _u((q >> 23) + (q >> 25) + (z >> 63))
                s[i] = _u(~_u((z << 1) + h))
            s[ICARRY] = carry
            self.iseed = 0
        s[IXCNG] = _u(s[IXCNG] * 6906969069 + 123)
        y = s[IXS]
        y = _u(y ^ (y << 13))
        y = y ^ (y >> 17)
        y = _u(y ^ (y << 43))
        s[IXS] = y
        out = _u(s[self.iseed] + s[IXCNG] + y)
        self.iseed += 1
        return out

    def int64(self) -> int:
        """Unsigned 64-bit draw from the selected engine."""
        if self.algorithm == 2:
            return self._mt19937_64()
        if self.algorithm == 3:
            return self._superkiss64()
        return self._kiss64_raw(self.seeds)

    def int64_signed(self) -> int:
        return _signed(self.int64())

    # ---- seeding (reference :244-381) ----

    def _init_seeds(self, seed_type: int, mype: int | None):
        nseed = self.nseed
        if seed_type == 3:
            try:
                raw = os.urandom(8 * nseed)
                vals = np.frombuffer(raw, dtype="<u8").tolist()
                self.seeds[:nseed] = [int(v) for v in vals]
                if self.algorithm == 1:
                    while self.seeds[1] == 0:
                        self.seeds[1] = int(np.frombuffer(os.urandom(8), "<u8")[0])
                    while self.seeds[0] == 0 and self.seeds[3] == 0:
                        self.seeds[0] = int(np.frombuffer(os.urandom(8), "<u8")[0])
                        self.seeds[3] = int(np.frombuffer(os.urandom(8), "<u8")[0])
                elif self.algorithm == 3:
                    while self.seeds[20634] == 0:
                        self.seeds[20634] = int(np.frombuffer(os.urandom(8), "<u8")[0])
                self._set_start_index()
                return
            except OSError:
                seed_type = 2
        # constant (1) or clock (2) seeds -> KISS-randomized (reference :301-351)
        if seed_type == 2:
            clock = time.monotonic_ns() & M64
        else:
            clock = _PRIMES1[1]  # primes1(1), reference :305
        sclock = _signed(clock)
        base = [sclock] * 4
        if mype is not None:
            idx = _fmod(abs(sclock + _PRIMES2[_fmod(abs(sclock), 100)] * mype), 100)
            base = [_signed(b + _PRIMES1[idx] * mype) for b in base]
        for i in range(4):
            idx = _fmod(abs(base[i] + _PRIMES1[_fmod(abs(sclock), 100)] * i), 100)
            base[i] = _signed(base[i] + _PRIMES2[idx] * i)
        kiss_state = [_u(b) for b in base]
        tmp = [0] * 20635
        for _ in range(20):  # warm up KISS (reference :323-325)
            tmp[0] = self._kiss64_raw(kiss_state)
        for i in range(1, nseed):
            tmp[i] = self._kiss64_raw(kiss_state)
        if self.algorithm == 1:
            while tmp[1] == 0:
                tmp[1] = self._kiss64_raw(kiss_state)
            while tmp[0] == 0 and tmp[3] == 0:
                tmp[0] = self._kiss64_raw(kiss_state)
                tmp[3] = self._kiss64_raw(kiss_state)
        elif self.algorithm == 3:
            # the reference's correction loop (:346-348) tests the stale
            # multirand_seeds array instead of tmpseeds (aliasing slip) and is
            # a no-op in practice; the intended correction is applied here
            while tmp[20634] == 0:
                tmp[20634] = self._kiss64_raw(kiss_state)
        self.seeds = tmp
        self._set_start_index()

    def _set_start_index(self):
        if self.algorithm == 2:
            self.iseed = 312      # force refill on first draw (:356-366)
        elif self.algorithm == 3:
            self.iseed = 20632

    # ---- distributions (reference :576-914) ----

    def real64(self) -> float:
        """Uniform [0, 1]: INT2REAL64 macro (:49)."""
        return _signed(self.int64()) / MAX_U64 + 0.5

    def real_array(self, n: int) -> np.ndarray:
        return np.array([self.real64() for _ in range(n)])

    def gaussian64(self) -> float:
        if self._gauss_buf is not None:
            g, self._gauss_buf = self._gauss_buf, None
            return g
        while True:
            x = _signed(self.int64()) / MAX_I64
            y = _signed(self.int64()) / MAX_I64
            s = x * x + y * y
            if 0.0 < s < 1.0:
                break
        f = np.sqrt(-2.0 * np.log(s) / s)
        self._gauss_buf = f * y
        return f * x

    def gaussian_array(self, n: int) -> np.ndarray:
        """Matches multirand_gaussian_array64 buffering (:846-881): a leading
        buffered value is consumed first, and a trailing odd value leaves its
        pair partner in the buffer."""
        out = np.empty(n)
        i = 0
        if self._gauss_buf is not None:
            out[0], self._gauss_buf = self._gauss_buf, None
            i = 1
        while i < n:
            while True:
                x = _signed(self.int64()) / MAX_I64
                y = _signed(self.int64()) / MAX_I64
                s = x * x + y * y
                if 0.0 < s < 1.0:
                    break
            f = np.sqrt(-2.0 * np.log(s) / s)
            out[i] = f * x
            if i + 1 < n:
                out[i + 1] = f * y
            else:
                self._gauss_buf = f * y
            i += 2
        return out

    # ---- 32-bit variants: 64 -> 2x32 split buffering (reference :576-637,
    # :651-658, :712-777, :806-831, :883-914).  Each 64-bit draw yields two
    # 32-bit values (low word first, INT64TO32_1/2 macros :54-55); an odd
    # consumer leaves the high word in the carry buffer.  Real conversion and
    # the Gaussian polar method run in float32 arithmetic, as in the
    # reference's mrkr32 kind. ----

    def int32(self) -> int:
        """Signed 32-bit draw (multirand_int32, :576-590)."""
        if self._int32_buf is not None:
            out, self._int32_buf = self._int32_buf, None
            return out
        i64 = self.int64()
        self._int32_buf = _i32(i64 >> 32)
        return _i32(i64)

    def real32(self) -> np.float32:
        """Uniform [0, 1] float32: INT2REAL32 macro (:50, :651-658)."""
        return np.float32(np.float32(self.int32()) / MAX_U32 + np.float32(0.5))

    def real_array32(self, n: int) -> np.ndarray:
        """multirand_real_array32 (:712-777): leading carry value first, then
        pairwise fill; an odd tail leaves the high word buffered."""
        out = np.empty(n, dtype=np.float32)
        i = 0
        if self._int32_buf is not None:
            out[0] = np.float32(np.float32(self._int32_buf) / MAX_U32
                                + np.float32(0.5))
            self._int32_buf = None
            i = 1
        while i < n:
            i64 = self.int64()
            out[i] = np.float32(np.float32(_i32(i64)) / MAX_U32
                                + np.float32(0.5))
            if i + 1 < n:
                out[i + 1] = np.float32(np.float32(_i32(i64 >> 32)) / MAX_U32
                                        + np.float32(0.5))
            else:
                self._int32_buf = _i32(i64 >> 32)
            i += 2
        return out

    def gaussian32(self) -> np.float32:
        """Marsaglia polar method in float32; one 64-bit draw feeds both
        coordinates (multirand_gaussian32, :806-831)."""
        if self._gauss32_buf is not None:
            g, self._gauss32_buf = self._gauss32_buf, None
            return g
        while True:
            i64 = self.int64()
            x = np.float32(np.float32(_i32(i64)) / MAX_I32)
            y = np.float32(np.float32(_i32(i64 >> 32)) / MAX_I32)
            s = np.float32(x * x + y * y)
            if np.float32(0.0) < s < np.float32(1.0):
                break
        f = np.float32(np.sqrt(np.float32(-2.0) * np.log(s) / s))
        self._gauss32_buf = np.float32(f * y)
        return np.float32(f * x)

    def gaussian_array32(self, n: int) -> np.ndarray:
        """multirand_gaussian_array32 buffering (:883-914)."""
        out = np.empty(n, dtype=np.float32)
        i = 0
        if self._gauss32_buf is not None:
            out[0], self._gauss32_buf = self._gauss32_buf, None
            i = 1
        while i < n:
            while True:
                i64 = self.int64()
                x = np.float32(np.float32(_i32(i64)) / MAX_I32)
                y = np.float32(np.float32(_i32(i64 >> 32)) / MAX_I32)
                s = np.float32(x * x + y * y)
                if np.float32(0.0) < s < np.float32(1.0):
                    break
            f = np.float32(np.sqrt(np.float32(-2.0) * np.log(s) / s))
            out[i] = np.float32(f * x)
            if i + 1 < n:
                out[i + 1] = np.float32(f * y)
            else:
                self._gauss32_buf = np.float32(f * y)
            i += 2
        return out

    # ---- known-answer self-test (reference :390-553) ----

    GOLDEN = {
        1: {
            "head": [
                8932985056925012148, 5710300428094272059,
                -104233206776033023, -4143107803135683366,
                542381058189297533, -4244931820854714191,
                6853720724624422285, -767542866500872268,
                -257204313086867125, 8128797625455304420,
            ],
            "seeds": [1234567890987654321, 362436362436362436,
                      1066149217761810, 123456123456123456],
        },
        2: {
            "head": [
                -3932459287431434586, 4620546740167642908,
                -5337173792191653896, -983805426561117294,
                355488278567739596, 7469126240319926998,
                4635995468481642529, 418970542659199878,
                -8842573084457035060, 6358044926049913402,
            ],
            "tail": [
                -7948593974297132281, 1921007855220546564,
                7643484074408755248, -7128315020423208677,
                1370093900783164344, 6776537281339823025,
                3450492372588984223, -9045729527952115285,
                7896519943553875907, -4143300141377237606,
            ],
        },
        3: {
            "head": [
                6140839658375754198, -95225469143006167,
                -9148462456964506707, 3912874252778582253,
                6801212277726928591, -809575511391043410,
                -397286769868273005, 4963780769400405858,
                2406624640673457322, 1246843699883922102,
            ],
            "tail": [
                -1387224431860786161, -8846516422183390713,
                8111357788999165247, 444070776306226770,
                -7730678117654887867, -296399128303442035,
                -1658509282659454084, -8190332265239255687,
                -1492517620356299342, -5016179395587873849,
            ],
        },
    }

    def selftest(self) -> list[str]:
        """Run the reference's default-seed known-answer test for this
        engine.  Returns a list of mismatch descriptions (empty = pass).
        Engine state is reset to default seeds by this call; re-seed after
        (the reference has the same caveat, :387-388)."""
        errors: list[str] = []
        ntest = 10
        g = self.GOLDEN[self.algorithm]
        if self.algorithm == 2:
            self.seeds = [0] * 20635
            self.seeds[0] = 5489
            for i in range(1, 312):
                prev = self.seeds[i - 1]
                self.seeds[i] = _u(6364136223846793005 * (prev ^ (prev >> 62)) + i)
            self.iseed = 312
            itail = 312 - ntest // 2
        elif self.algorithm == 3:
            self.seeds = [0] * 20635
            self.seeds[20632:20635] = [36243678541, 12367890123456, 521288629546311]
            for i in range(20632):
                self.seeds[20633] = _u(self.seeds[20633] * 6906969069 + 123)
                y = self.seeds[20634]
                y = _u(y ^ (y << 13))
                y = y ^ (y >> 17)
                y = _u(y ^ (y << 43))
                self.seeds[20634] = y
                self.seeds[i] = _u(self.seeds[20633] + y)
            self.iseed = 20632
            itail = 20632 - ntest // 2
        else:
            self.seeds = [0] * 20635
            self.seeds[0:4] = g["seeds"]
            itail = None

        head = [self.int64_signed() for _ in range(ntest)]
        if head != g["head"]:
            errors.append(f"algorithm {self.algorithm} head sequence mismatch")
        elif itail is not None:
            for _ in range(ntest + 1, itail + 1):
                self.int64()
            tail = [self.int64_signed() for _ in range(ntest)]
            if tail != g["tail"]:
                errors.append(f"algorithm {self.algorithm} tail sequence mismatch")
        return errors
