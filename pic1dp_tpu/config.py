"""Runtime configuration for pic1dp_tpu.

The reference implementation hard-codes every run parameter as a Fortran
compile-time constant (reference src/pic1dp_input.F90:26-256) and requires a
rebuild to change any of them.  Here the same parameter surface is a frozen
(hashable) dataclass, so a `Config` can be passed as a static argument to
jitted step functions, loaded from JSON/CLI, and varied per run.

Parameter-by-parameter parity map (reference src/pic1dp_input.F90):
    ntime_max / time_max        :32-35    termination
    linear                      :43       0 nonlinear / 1 linear  -> bool
    lx                          :46-47
    iptcldist                   :50-54    -> equilibrium (str enum)
    nspecies + species arrays   :57-72    -> tuple[SpeciesConfig]
    nmode / modes               :75-80
    init_nmode/mode/cos/sin     :87-98    -> perturbation tuple
    deltaf                      :106      -> bool
    dt                          :109
    nparticle_max               :113
    nparticle_init              :116-117  (per species)
    imarker                     :122      -> MarkerLoading
    v_max                       :125
    nx                          :128
    nv                          :131
    iptclshape                  :133-138  -> ParticleShape
    merge/remove/split params   :146-206  -> OptimizationConfig
    multirand params            :217-233  -> RngConfig
    verbosity                   :246
    output_interval             :250
    nx_opd / nv_opd             :253-256
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
from typing import Sequence


class Equilibrium(str, enum.Enum):
    """Equilibrium velocity distribution selector.

    Reference src/pic1dp_input.F90:49-54 (input_iptcldist):
      0 -> MAXWELLIAN (shifted), 1 -> TWO_STREAM1, 2 -> TWO_STREAM2,
      3 -> BUMP_ON_TAIL.
    """

    MAXWELLIAN = "maxwellian"
    TWO_STREAM1 = "two_stream1"
    TWO_STREAM2 = "two_stream2"
    BUMP_ON_TAIL = "bump_on_tail"

    @classmethod
    def from_index(cls, i: int) -> "Equilibrium":
        return (cls.MAXWELLIAN, cls.TWO_STREAM1, cls.TWO_STREAM2, cls.BUMP_ON_TAIL)[i]

    @property
    def index(self) -> int:
        return {
            Equilibrium.MAXWELLIAN: 0,
            Equilibrium.TWO_STREAM1: 1,
            Equilibrium.TWO_STREAM2: 2,
            Equilibrium.BUMP_ON_TAIL: 3,
        }[self]


class MarkerLoading(str, enum.Enum):
    """Marker distribution in velocity space (reference input_imarker :119-122).

    PHYSICAL: markers ~ f0 (only Maxwellian supported, as in the reference's
    input_init validation :287-300).  UNIFORM: markers uniform in [-v_max, v_max].
    """

    PHYSICAL = "physical"
    UNIFORM = "uniform"


class ParticleShape(enum.IntEnum):
    """Shape-matrix strategy (reference input_iptclshape :133-138).

    The reference's four strategies collapse to two meaningful ones here:
      EXPLICIT (1-3): materialize the sparse shape matrix S (COO) and apply
        it via the transposed-pair contraction kernels (ops/shape_matrix.py).
      MATRIX_FREE (4): recompute hat weights on the fly in the fused
        gather/push/deposit step; no storage.  Default, like the reference.
    """

    EXPLICIT = 1
    MATRIX_FREE = 4


class DepositMethod(str, enum.Enum):
    """Backend for charge deposition / field gather.

    AUTO: resolved at Stepper construction (core/step.py _auto_method):
          PALLAS for the matrix-free shape on a GPU backend; otherwise
          SEGMENT at nx >= 512 and ONEHOT below.
    ONEHOT: chunked one-hot contraction (pure XLA).
    TWOLEVEL: factorized (hi, lo)-digit one-hot contraction, nx/128 + 128
          compares per entry instead of nx (pure XLA; a test reference).
    SEGMENT: jax segment_sum scatter-add (pure XLA).
    PALLAS: the fused Triton substep kernels (ops/pallas_kernels.py).
    """

    AUTO = "auto"
    ONEHOT = "onehot"
    TWOLEVEL = "twolevel"
    SEGMENT = "segment"
    PALLAS = "pallas"


@dataclasses.dataclass(frozen=True)
class SpeciesConfig:
    """Per-species physical parameters (reference src/pic1dp_input.F90:59-72).

    charge: units of proton charge e; mass: units of electron mass;
    temperature / temperature2: units of electron temperature (temperature2 is
    the beam temperature for bump-on-tail); density: units of electron
    equilibrium density (for bump-on-tail it is the *core fraction*);
    v0: equilibrium flow in electron thermal velocity units.
    """

    charge: float = -1.0
    mass: float = 1.0
    temperature: float = 1.0
    temperature2: float = 1.0
    density: float = 0.9
    v0: float = 5.0
    nparticle_init: int | None = None  # default: nparticle_max


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Marker merge/remove/split schedules (reference src/pic1dp_input.F90:141-206)."""

    tmerge: tuple[float, ...] = ()
    thshmerge: tuple[float, ...] = ()
    tremove: tuple[float, ...] = ()
    typeremove: int = 2          # 1: threshold+frac, 2: importance profile (:169-172)
    thshremove: tuple[float, ...] = ()
    remove_frac: float = 0.9     # (:182-184)
    tsplit: tuple[float, ...] = ()
    thshsplit: tuple[float, ...] = ()
    split_ngroup: int = 5        # (:202-203)
    split_dv_sig_frac: float = 0.1  # (:205-206)


@dataclasses.dataclass(frozen=True)
class RngConfig:
    """RNG configuration.

    backend "jax": counter-based jax.random streams (the default).
    backend "multirand": deterministic multirand-compatible loading — the
    KISS64 / MT19937-64 / SuperKISS64 engines of reference src/multirand.F90,
    reproduced bit-exactly in pic1dp_tpu.rng.multirand (host-side; used for
    particle loading so runs can be compared marker-for-marker with the
    reference).  algorithm/seed_type/warmup/selftest mirror
    reference src/pic1dp_input.F90:212-233.
    """

    backend: str = "jax"          # "jax" | "multirand"
    seed: int = 0                 # jax backend PRNG seed
    algorithm: int = 3            # 1 KISS64, 2 MT19937-64, 3 SuperKISS64 (:217)
    seed_type: int = 1            # 1 constant, 2 clock, 3 urandom (:223)
    warmup: int = 5               # (:226)
    selftest: bool = True         # (:233)


@dataclasses.dataclass(frozen=True)
class Config:
    """Full run configuration.  Frozen + tuples only => hashable, so it can be
    a static argument of jitted step functions."""

    # termination (reference :32-35)
    ntime_max: int = 900000
    time_max: float = 500.0

    # physics (reference :42-80)
    linear: bool = False
    lx: float = 2.0 * math.pi / 0.36
    equilibrium: Equilibrium = Equilibrium.BUMP_ON_TAIL
    species: tuple[SpeciesConfig, ...] = (SpeciesConfig(),)
    modes: tuple[int, ...] = (1,)

    # initial condition (reference :86-98)
    init_modes: tuple[int, ...] = (1,)
    init_amp_cos: tuple[float, ...] = (0.0,)
    init_amp_sin: tuple[float, ...] = (1e-5,)

    # numerics (reference :101-138)
    deltaf: bool = True
    dt: float = 0.05
    nparticle_max: int = 6_400_000
    marker: MarkerLoading = MarkerLoading.UNIFORM
    v_max: float = 8.0
    nx: int = 192
    nv: int = 128
    shape: ParticleShape = ParticleShape.MATRIX_FREE

    # numerics of this implementation (no reference equivalent)
    dtype: str = "float32"            # particle/field dtype
    deposit_method: DepositMethod = DepositMethod.AUTO
    deposit_chunk: int = 16384        # particles per one-hot contraction chunk
    # On the matrix-free path the in-state rho(x) is the kept-mode
    # reconstruction (all the solver ever uses).  Set True to additionally
    # deposit the FULL grid charge at snapshot time, byte-matching the
    # reference's diagnostic rho stream (costs one histogram per snapshot).
    diag_full_rho: bool = False
    # Opt-in reduced-precision weights: store the constant marker weights p
    # in bfloat16 and round the midpoint weights w1 to bfloat16 before the
    # substep-2 drive (the midpoint deposit keeps the full-precision w1).
    # Every path (XLA step, fused kernels, push pair) computes the same
    # arithmetic.  p and w1 only enter the delta-f drive (p - w) E
    # (-f0'/f0), so the <=0.4% relative quantization acts as additional
    # marker-weight loading noise, far below the sampling noise of any
    # realistic marker count (docs/performance.md).  Requires dtype
    # float32 and delta-f.
    bf16_weights: bool = False

    # optimization schedules
    optimization: OptimizationConfig = OptimizationConfig()

    # rng
    rng: RngConfig = RngConfig()

    # output (reference :236-256)
    verbosity: int = 1
    output_interval: float = 0.5
    nx_opd: int = 64
    nv_opd: int = 64

    # ---- derived helpers (not fields) ----

    @property
    def nspecies(self) -> int:
        return len(self.species)

    @property
    def nmode(self) -> int:
        return len(self.modes)

    @property
    def p_dtype(self) -> str:
        """Storage dtype of the constant marker weights p (and the fused
        kernel's w1 stream); the rest of the state keeps `dtype`."""
        return "bfloat16" if self.bf16_weights else self.dtype

    @property
    def nparticle_init(self) -> tuple[int, ...]:
        return tuple(
            s.nparticle_init if s.nparticle_init is not None else self.nparticle_max
            for s in self.species
        )

    def validate(self) -> "Config":
        """Precondition checks (reference input_init src/pic1dp_input.F90:287-308)."""
        if self.equilibrium != Equilibrium.MAXWELLIAN and self.marker == MarkerLoading.PHYSICAL:
            raise ValueError(
                "physical marker loading is only implemented for the (shifted) "
                "Maxwellian equilibrium (reference src/pic1dp_input.F90:292-300)"
            )
        if self.linear and not self.deltaf:
            raise ValueError(
                "linear full-f is not implemented "
                "(reference src/pic1dp_input.F90:301-307)"
            )
        if self.bf16_weights and self.dtype != "float32":
            raise ValueError("bf16_weights requires dtype float32 "
                             "(it is a traffic optimization of the f32 hot "
                             "path; f64 runs want full-precision weights)")
        if self.bf16_weights and not self.deltaf:
            # the measured error budget (a gamma shift far below the
            # sampling noise on the PRE 83 case) holds for delta-f, where p and
            # w1 only enter the drive; in full-f, p IS the deposited charge
            # and with PHYSICAL loading all p are equal, so bf16 rounding
            # becomes a systematic density bias instead of loading noise
            raise ValueError("bf16_weights requires deltaf=True (the "
                             "reduced-precision error budget is only "
                             "established for delta-f weights)")
        if self.output_interval < 2 * self.dt:
            raise ValueError("output_interval must be at least 2*dt "
                             "(reference src/pic1dp_input.F90:248-250)")
        if len(self.init_modes) != len(self.init_amp_cos) or len(self.init_modes) != len(self.init_amp_sin):
            raise ValueError("init_modes / init_amp_cos / init_amp_sin length mismatch")
        if any(n > self.nparticle_max for n in self.nparticle_init):
            raise ValueError("nparticle_init exceeds nparticle_max")
        opt = self.optimization
        if len(opt.tmerge) != len(opt.thshmerge):
            raise ValueError("tmerge / thshmerge length mismatch")
        if opt.typeremove == 1 and len(opt.tremove) != len(opt.thshremove):
            raise ValueError("tremove / thshremove length mismatch")
        if len(opt.tsplit) != len(opt.thshsplit):
            raise ValueError("tsplit / thshsplit length mismatch")
        return self

    # ---- (de)serialization ----

    def to_dict(self) -> dict:
        """JSON-compatible dict, round-trippable through from_dict."""
        def enc(o):
            if dataclasses.is_dataclass(o) and not isinstance(o, type):
                return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
            if isinstance(o, enum.Enum):
                return o.value
            if isinstance(o, (list, tuple)):
                return [enc(v) for v in o]
            return o

        return {k: enc(getattr(self, k))
                for k in (f.name for f in dataclasses.fields(self))}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        d = dict(d)
        if "species" in d:
            d["species"] = tuple(
                SpeciesConfig(**s) if isinstance(s, dict) else s for s in d["species"]
            )
        if "optimization" in d and isinstance(d["optimization"], dict):
            opt = dict(d["optimization"])
            for k in ("tmerge", "thshmerge", "tremove", "thshremove", "tsplit", "thshsplit"):
                if k in opt:
                    opt[k] = tuple(opt[k])
            d["optimization"] = OptimizationConfig(**opt)
        if "rng" in d and isinstance(d["rng"], dict):
            d["rng"] = RngConfig(**d["rng"])
        for k in ("modes", "init_modes", "init_amp_cos", "init_amp_sin"):
            if k in d:
                d[k] = tuple(d[k])
        for k, typ in (("equilibrium", Equilibrium), ("marker", MarkerLoading),
                       ("deposit_method", DepositMethod)):
            if k in d and isinstance(d[k], str):
                d[k] = typ(d[k])
        if "shape" in d and isinstance(d["shape"], int):
            d["shape"] = ParticleShape(d["shape"])
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))


# ---- canonical benchmark configurations (BASELINE.json "configs") ----

def bump_on_tail_default(**overrides) -> Config:
    """The reference's default case: electron bump-on-tail instability with
    the parameters of PRE 83, 056402 Sec. V.A.2 (reference README.md:107-109,
    src/pic1dp_input.F90 defaults)."""
    return Config(**overrides).validate()


def landau_damping(nx: int = 64, nparticle: int = 100_000, k: float = 0.5,
                   amp: float = 1e-4, time_max: float = 25.0, **overrides) -> Config:
    """Linear Landau damping of a Maxwellian plasma: the classic verification
    case (BASELINE.md config 2)."""
    cfg = Config(
        linear=False,
        lx=2.0 * math.pi / k,
        equilibrium=Equilibrium.MAXWELLIAN,
        species=(SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                               density=1.0, v0=0.0),),
        nx=nx,
        nparticle_max=nparticle,
        init_amp_sin=(amp,),
        time_max=time_max,
        v_max=6.0,
        **overrides,
    )
    return cfg.validate()


def two_stream(nx: int = 256, nparticle: int = 1_000_000, k: float = 0.2,
               v0: float = 3.0, time_max: float = 100.0, **overrides) -> Config:
    """Nonlinear two-stream instability (BASELINE.md config 3), using the
    two-stream2 equilibrium (pair of counter-streaming Maxwellians,
    reference src/pic1dp_input.F90:52)."""
    cfg = Config(
        linear=False,
        lx=2.0 * math.pi / k,
        equilibrium=Equilibrium.TWO_STREAM2,
        species=(SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                               density=1.0, v0=v0),),
        nx=nx,
        nparticle_max=nparticle,
        time_max=time_max,
        **overrides,
    )
    return cfg.validate()
