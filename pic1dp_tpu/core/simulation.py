"""End-to-end simulation driver.

Reference equivalent: program pic1dp (src/pic1dp.F90:20-126): initialize,
load, initial field solve, RK2 main loop with scheduled particle optimization
and interval-based output, finalize with a timer report.

The driver is host-side Python; everything per-step runs in one jitted
XLA computation (core/step.py).  Output snapshots synchronize the device at
most once per `output_interval`.
"""

from __future__ import annotations

import math
import sys
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from pic1dp_tpu.config import Config
from pic1dp_tpu.core import diagnostics
from pic1dp_tpu.core.loading import PertbShape, load_particles
from pic1dp_tpu.core.state import SimState
from pic1dp_tpu.core.step import Stepper
from pic1dp_tpu.io.writer import SnapshotWriter
from pic1dp_tpu.utils.timers import PhaseTimers

_EPS = math.sqrt(np.finfo(np.float64).eps)  # PETSC_SQRT_MACHINE_EPSILON


class Simulation:
    def __init__(self, cfg: Config, pertb_shape: PertbShape | None = None,
                 out_path: str | None = None, emulate_ranks: int = 1,
                 checkpoint_interval: float | None = None,
                 checkpoint_path: str | None = None, mesh=None):
        """`mesh`: None for single-device; a jax.sharding.Mesh (or a device
        count for a 1-D mesh) runs the whole step pipeline under shard_map
        with the particle axis sharded (parallel/mesh.py)."""
        from pic1dp_tpu.utils.compile_cache import enable_compilation_cache

        enable_compilation_cache()  # no-op if the user already configured one
        self.cfg = cfg.validate()
        self.checkpoint_interval = checkpoint_interval
        self.checkpoint_path = checkpoint_path or "."
        self._last_checkpoint_time = 0.0
        self.timers = PhaseTimers()
        self.mesh = None
        with self.timers.phase("initialize"):
            if mesh is not None:
                from pic1dp_tpu.parallel import mesh as pmesh

                self.mesh = pmesh.make_mesh(mesh) if isinstance(mesh, int) \
                    else mesh
                self.stepper = pmesh.ShardedStepper(cfg, self.mesh)
            else:
                self.stepper = Stepper(cfg)
        self._is_io_process = jax.process_index() == 0
        self.pertb_shape = pertb_shape
        self.emulate_ranks = emulate_ranks
        self.writer = SnapshotWriter(cfg, out_path) \
            if out_path is not None and jax.process_index() == 0 else None
        self.state: SimState | None = None
        self.itime = 0
        self.time = 0.0
        self.key = jax.random.PRNGKey(cfg.rng.seed)
        # optimization schedule cursors (reference particle_imerge/iremove/
        # isplit, src/pic1dp_particle.F90:26, :73-87)
        self._imerge = 0
        self._iremove = 0
        self._isplit = 0
        self._multi_step_cache: dict[int, Callable] = {}

    # ---- lifecycle ----

    def load(self) -> SimState:
        """Load markers and solve the initial field
        (reference src/pic1dp.F90:63-72)."""
        with self.timers.phase("particle load"):
            self.key, sub = jax.random.split(self.key)
            state = load_particles(self.cfg, sub, self.pertb_shape,
                                   self.emulate_ranks)
            if self.mesh is not None:
                from pic1dp_tpu.parallel import mesh as pmesh

                state = pmesh.shard_state(state, self.mesh)
            state = self.stepper.initial_field(state)
            jax.block_until_ready(state.electric)
        self.state = state
        self.itime = 0
        self.time = 0.0
        return state

    def _check_termination(self) -> bool:
        """reference check_termination (src/pic1dp.F90:133-148)."""
        return (self.itime >= self.cfg.ntime_max
                or self.time + _EPS >= self.cfg.time_max)

    def _output_due(self) -> bool:
        """Time just crossed a full output interval
        (reference src/pic1dp.F90:98-106)."""
        interval = self.cfg.output_interval
        return math.fmod(self.time + _EPS, interval) < \
            math.fmod(self.time + _EPS - self.cfg.dt, interval)

    def _optimization_due(self) -> tuple[float | None, float | None, float | None]:
        """Thresholds for merge/remove/split if scheduled for this step
        (reference particle_optimize, src/pic1dp_particle.F90:752-813)."""
        opt = self.cfg.optimization
        t_next = self.time + self.cfg.dt
        merge = remove = split = None
        if not self.cfg.deltaf:
            return None, None, None  # delta-f only (reference :762)
        if self._imerge < len(opt.tmerge) and t_next >= opt.tmerge[self._imerge]:
            merge = opt.thshmerge[self._imerge]
        if self._iremove < len(opt.tremove) and t_next >= opt.tremove[self._iremove]:
            remove = (opt.thshremove[self._iremove]
                      if opt.typeremove == 1 and opt.thshremove else 0.0)
        if self._isplit < len(opt.tsplit) and t_next >= opt.tsplit[self._isplit]:
            split = opt.thshsplit[self._isplit]
        return merge, remove, split

    def step_once(self) -> None:
        """Advance one full RK2 step, applying scheduled optimization."""
        assert self.state is not None, "call load() first"
        merge, remove, split = self._optimization_due()
        if merge is None and remove is None and split is None:
            self.state = self.stepper.step(self.state)
        else:
            # sub-phase timers nest inside run()'s "step" phase, mirroring
            # the reference's overlapping wtimer slots (push/optimize/collect
            # inside total, src/pic1dp_global.F90:38-50)
            with self.timers.phase("step: push pair"):
                state = self.stepper.push_pair(self.state)
            self.key, sub = jax.random.split(self.key)
            with self.timers.phase("optimize particle"):
                state = self.stepper.apply_optimizations(
                    state, sub, merge=merge, remove=remove, split=split)
            if merge is not None:
                self._imerge += 1
            if remove is not None:
                self._iremove += 1
            if split is not None:
                self._isplit += 1
            with self.timers.phase("step: collect + solve"):
                self.state = self.stepper.collect_and_solve(state)
            if self.cfg.verbosity >= 1:
                n = int(np.sum(np.asarray(self.state.nparticles())))
                # reference output_progress(2), src/pic1dp_output.F90:528-532
                # (level 1: progress-prefixed line) / :544-546 (level >= 2)
                if self.cfg.verbosity == 1:
                    tag, pct = self._progress_pct(
                        self.itime + 1, self.time + self.cfg.dt)
                    self._print(
                        f"{tag}{pct:5.1f}% {self.itime + 1:7d} "
                        f"{self.time + self.cfg.dt:9.3f} : optimization "
                        f"performed, current # of particles {n}")
                else:
                    self._print("Info: particle_optimize performed, "
                                f"current # of particles: {n}")
        self.itime += 1
        self.time += self.cfg.dt

    def output_snapshot(self) -> dict:
        """Compute + (optionally) write one snapshot; returns the scalars."""
        assert self.state is not None
        with self.timers.phase("output"):
            eng = self.stepper.energies(self.state)
            ptcl = self.stepper.ptcldist(self.state)
            rho = self.state.rho
            if self.cfg.diag_full_rho and self.writer is not None:
                # exact full-spectrum grid charge for the diagnostic stream
                # (reference writes the deposited rho, all modes)
                rho = self.stepper.full_rho(self.state)
            # ONE device->host transfer for the whole snapshot: each fetch
            # costs a synchronization, and a snapshot is ~10 arrays (the
            # reference's analogue is its single rank-0 binary write,
            # src/pic1dp_output.F90:173-187)
            fetch = (eng, ptcl, self.state.mode_re, self.state.mode_im,
                     self.state.electric, rho)
            if self.cfg.verbosity >= 3:  # one batched fetch (see below)
                fetch += (self.state.nparticles(),)
            fetched = jax.device_get(fetch)
            eng, ptcl, mode_re, mode_im, electric, rho = fetched[:6]
            nlive = fetched[6] if self.cfg.verbosity >= 3 else None
            if self.writer is not None:
                self.writer.write_snapshot(
                    self.time, eng, mode_re, mode_im, electric, rho, ptcl,
                )
        if self.cfg.verbosity >= 1:
            # pass the already-fetched snapshot values through: every extra
            # device_get costs another synchronization
            self._print_progress(eng, mode_re, mode_im, nlive)
        if not np.isfinite(eng.field):
            # failure detection the reference lacks (SURVEY.md section 5):
            # blow-ups surface as a hard error at the next snapshot instead
            # of silently producing garbage output
            raise FloatingPointError(
                f"non-finite field energy at t = {self.time:.4f} "
                f"(itime = {self.itime}); the run has diverged — reduce dt "
                "or check the configuration. Last checkpoint (if enabled) "
                f"is in {self.checkpoint_path!r}.")
        return {"time": self.time, "field_energy": float(eng.field),
                "marker": eng.marker, "total": eng.total, "pertb": eng.pertb,
                # kept-mode field amplitudes (already fetched above): the
                # clean linear-phase observable — analysis.dispersion.
                # fit_mode_omega estimates complex omega from their series
                "mode_re": mode_re, "mode_im": mode_im}

    def _plain_steps_ahead(self, limit: int = 4096) -> int:
        """Number of upcoming steps with no output, optimization, or
        termination event, by walking the schedule arithmetic forward in
        host time (exactly mirrors step_once/_output_due)."""
        k = 0
        itime, time = self.itime, self.time
        im, ir, isp = self._imerge, self._iremove, self._isplit
        opt = self.cfg.optimization
        while k < limit:
            t_next = time + self.cfg.dt
            if self.cfg.deltaf and (
                (im < len(opt.tmerge) and t_next >= opt.tmerge[im])
                or (ir < len(opt.tremove) and t_next >= opt.tremove[ir])
                or (isp < len(opt.tsplit) and t_next >= opt.tsplit[isp])
            ):
                break  # optimization event: must run the slow path
            itime, time = itime + 1, t_next
            interval = self.cfg.output_interval
            due = math.fmod(time + _EPS, interval) < \
                math.fmod(time + _EPS - self.cfg.dt, interval)
            done = (itime >= self.cfg.ntime_max
                    or time + _EPS >= self.cfg.time_max)
            k += 1
            if due or done:
                break
        # (itime, time) walked with the same repeated addition as step_once,
        # so chunked and per-step runs see identical schedule arithmetic
        return k, itime, time

    def _multi_step(self, k: int):
        if k not in self._multi_step_cache:
            self._multi_step_cache[k] = self.stepper.make_multi_step(k)
        return self._multi_step_cache[k]

    def run(self, snapshot_callback: Callable[[dict], None] | None = None) -> None:
        """Main loop (reference src/pic1dp.F90:77-109).  Steps between
        events run as ONE jitted lax.scan (a single device dispatch per
        output interval); steps with scheduled particle optimization take
        the per-step path."""
        if self.cfg.verbosity >= 1:
            # reference src/pic1dp.F90:54-55
            from pic1dp_tpu import __version__

            self._print(f"pic1dp_tpu version {__version__}")
        if self.state is None:
            self.load()
        if self.cfg.verbosity == 1:
            # header belongs to the compact format only (reference
            # src/pic1dp_output.F90:524-526 vs :537)
            self._print("progress:\nprogrss  itime     time  int E^2 dx")
        snap = self.output_snapshot()  # t = 0 snapshot (reference :74)
        if snapshot_callback:
            snapshot_callback(snap)
        while not self._check_termination():
            k, itime_k, time_k = self._plain_steps_ahead()
            with self.timers.phase("step"):
                if k > 1:
                    self.state = self._multi_step(k)(self.state)
                    self.itime, self.time = itime_k, time_k
                else:
                    self.step_once()
            if self._output_due() or self._check_termination():
                jax.block_until_ready(self.state.electric)
                snap = self.output_snapshot()
                if snapshot_callback:
                    snapshot_callback(snap)
            self._maybe_checkpoint()
        if self.writer is not None:
            self.writer.close()
        if self.cfg.verbosity >= 1:
            self._print(self.timers.report())

    def phase_table(self, steps: int = 10) -> str:
        """Instrumented per-phase step decomposition (push / shape+gather /
        collect / field solve / fused kernels), measured on the current state
        with the scan-slope method — the reference's wtimer granularity
        (src/pic1dp_output.F90:576-627) that plain whole-step timing cannot
        give under jit.  Costs extra compiles; run it once after (or instead
        of) a run via `python -m pic1dp_tpu.run --phase-table`."""
        from pic1dp_tpu.config import ParticleShape
        from pic1dp_tpu.utils.phase_split import (format_phase_table,
                                                  measure_phase_split)

        if self.state is None:
            self.load()
        if self.cfg.shape != ParticleShape.MATRIX_FREE:
            return ("Info: phase table requires the MATRIX_FREE shape "
                    "(the production hot path)")
        if jax.process_count() > 1:
            # the scan-slope host fetches need fully-addressable state
            return ("Info: phase table is not supported under multi-process "
                    "runs (the timing loops fetch to one host); run it on a "
                    "single-process mesh")
        # under a mesh the phase loops run shard_mapped on it with the
        # production shardings and psums — the table measures the actual
        # sharded step (measure_phase_split detects ShardedStepper)
        return format_phase_table(
            measure_phase_split(self.stepper, self.state, steps))

    # ---- checkpoint / resume (no reference equivalent: the reference
    # restarts from t = 0 on any failure, SURVEY.md section 5) ----

    _CK_FIELDS = ("x", "v", "p", "w", "live", "rho", "electric",
                  "mode_re", "mode_im")

    def save_checkpoint(self, path: str | None = None,
                        force_sharded: bool = False) -> str:
        """Write full restart state (particle arrays, field, time counters,
        RNG key, optimization-schedule cursors) as an .npz; atomic rename so
        a crash mid-write never corrupts the previous checkpoint.

        Multi-host: arrays spanning non-addressable devices cannot be
        gathered to one host (and would not fit anyway), so each process
        writes `<path>.procK.npz` holding its addressable shards keyed by
        their global particle-axis offsets; restore rebuilds the sharded
        arrays per process (same mesh/process layout required)."""
        import os
        import tempfile

        assert self.state is not None, "nothing to checkpoint"
        if path is None:
            path = os.path.join(self.checkpoint_path, "checkpoint.npz")
        fully_local = not force_sharded and all(
            getattr(getattr(self.state, f), "is_fully_addressable", True)
            for f in self._CK_FIELDS)
        def to_np(a):
            # npz cannot represent bfloat16 (it degrades to a raw void
            # dtype); store such arrays widened to f32 — lossless — and
            # restore re-quantizes per cfg.p_dtype
            a = np.asarray(a)
            return a.astype(np.float32) if a.dtype.kind == "V" or str(
                a.dtype) == "bfloat16" else a

        if fully_local:
            arrays = {f: to_np(getattr(self.state, f))
                      for f in self._CK_FIELDS}
        else:
            path = f"{path}.proc{jax.process_index()}.npz"
            arrays = {}
            for f in self._CK_FIELDS:
                arr = getattr(self.state, f)
                if arr.ndim == 2:  # particle arrays: shard per offset
                    for sh in arr.addressable_shards:
                        start = sh.index[1].start or 0
                        arrays[f"{f}@{start}"] = to_np(sh.data)
                else:              # replicated field arrays
                    arrays[f] = to_np(arr.addressable_shards[0].data)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                itime=self.itime, time=self.time,
                imerge=self._imerge, iremove=self._iremove,
                isplit=self._isplit,
                key=np.asarray(self.key),
                config_json=np.frombuffer(
                    self.cfg.to_json().encode(), dtype=np.uint8),
                **arrays,
            )
        os.replace(tmp, path)
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Resume from save_checkpoint output (config must match; a
        mismatch raises so silent divergence is impossible).  Per-process
        shard files (multi-host saves) are detected by their key layout and
        rebuilt onto this Simulation's mesh."""
        import os

        if not os.path.exists(path) and self.mesh is not None:
            proc = f"{path}.proc{jax.process_index()}.npz"
            if os.path.exists(proc):
                path = proc
        with np.load(path) as ck:
            saved_cfg = bytes(ck["config_json"]).decode()
            if saved_cfg != self.cfg.to_json():
                # allow fields that don't affect the saved state or its
                # physics to differ — extending a run (time_max/ntime_max),
                # changing output cadence/verbosity, or re-tuning the
                # execution knobs is exactly what resume is for
                import json

                run_only = {"time_max", "ntime_max", "output_interval",
                            "verbosity", "deposit_method", "deposit_chunk",
                            "diag_full_rho", "nx_opd", "nv_opd"}
                a = json.loads(saved_cfg)
                b = json.loads(self.cfg.to_json())
                diff = {k for k in set(a) | set(b)
                        if a.get(k) != b.get(k)} - run_only
                if diff:
                    raise ValueError(
                        f"checkpoint {path} was written with a different "
                        f"config (state-affecting fields differ: "
                        f"{sorted(diff)})")
            sharded_keys = any("@" in k for k in ck.files)
            if sharded_keys:
                self.state = self._rebuild_sharded_state(ck)
            else:
                state = SimState(
                    x=jnp.asarray(ck["x"]), v=jnp.asarray(ck["v"]),
                    p=jnp.asarray(ck["p"], jnp.dtype(self.cfg.p_dtype)),
                    w=jnp.asarray(ck["w"]),
                    live=jnp.asarray(ck["live"]), rho=jnp.asarray(ck["rho"]),
                    electric=jnp.asarray(ck["electric"]),
                    mode_re=jnp.asarray(ck["mode_re"]),
                    mode_im=jnp.asarray(ck["mode_im"]),
                )
                if self.mesh is not None:
                    from pic1dp_tpu.parallel import mesh as pmesh

                    state = pmesh.shard_state(state, self.mesh)
                self.state = state
            self.itime = int(ck["itime"])
            self.time = float(ck["time"])
            self._imerge = int(ck["imerge"])
            self._iremove = int(ck["iremove"])
            self._isplit = int(ck["isplit"])
            self.key = jnp.asarray(ck["key"])
        self._last_checkpoint_time = self.time

    def _rebuild_sharded_state(self, ck) -> SimState:
        """Reassemble sharded particle arrays from a per-process checkpoint
        via make_array_from_callback (only locally-saved slices are read, so
        this works when the global array spans non-addressable devices)."""
        from jax.sharding import NamedSharding

        from pic1dp_tpu.parallel import mesh as pmesh

        if self.mesh is None:
            raise ValueError(
                "per-process (sharded) checkpoint requires Simulation(mesh=...) "
                "with the same mesh layout it was saved under")
        specs = pmesh.state_specs()
        ns, n = self.cfg.nspecies, self.cfg.nparticle_max
        shapes = SimState(
            x=(ns, n), v=(ns, n), p=(ns, n), w=(ns, n), live=(ns, n),
            rho=(self.cfg.nx,), electric=(self.cfg.nx,),
            mode_re=(self.cfg.nmode,), mode_im=(self.cfg.nmode,))
        fields = {}
        for f in self._CK_FIELDS:
            spec = getattr(specs, f)
            sharding = NamedSharding(self.mesh, spec)
            shape = getattr(shapes, f)
            # p may be stored reduced-precision in the live state; the
            # checkpoint holds it widened to f32 (see save_checkpoint)
            dt = jnp.dtype(self.cfg.p_dtype) if f == "p" else None
            if len(shape) == 2:
                def cb(index, f=f, dt=dt):
                    start = index[1].start or 0
                    a = ck[f"{f}@{start}"]
                    return a if dt is None else a.astype(dt)
            else:
                def cb(index, f=f):
                    return ck[f][index]
            fields[f] = jax.make_array_from_callback(shape, sharding, cb)
        return SimState(**fields)

    def _maybe_checkpoint(self) -> None:
        if (self.checkpoint_interval is not None
                and self.time - self._last_checkpoint_time
                >= self.checkpoint_interval - _EPS):
            path = self.save_checkpoint()
            self._last_checkpoint_time = self.time
            if self.cfg.verbosity >= 2:
                self._print(f"checkpoint written: {path}")

    # ---- logging (reference output_progress, src/pic1dp_output.F90:483-548) ----

    def _print(self, msg: str) -> None:
        # reference global_pp prints once from rank 0
        # (src/pic1dp_global.F90:71-90); same gating for multi-process runs
        if self._is_io_process:
            print(msg, file=sys.stderr)

    def _progress_pct(self, itime: int, time: float) -> tuple[str, float]:
        pi = 100.0 * itime / self.cfg.ntime_max
        pt = 100.0 * time / self.cfg.time_max
        return ("i", pi) if pi >= pt else ("t", pt)

    def _print_progress(self, eng, mode_re, mode_im, nlive=None) -> None:
        """Reference output_progress levels (src/pic1dp_output.F90:483-548
        and src/pic1dp_input.F90:240-246): 1 = compact percent line;
        2 = per-event "finished itime" lines; 3 adds a diagnostic dump of
        the snapshot's variables.  All arguments are host values already
        fetched by output_snapshot — no extra device round trips."""
        if self.cfg.verbosity == 1:
            tag, pct = self._progress_pct(self.itime, self.time)
            self._print(f"{tag}{pct:5.1f}% {self.itime:7d} {self.time:9.3f} "
                        f"{float(eng.field):12.3e}")
        elif self.cfg.verbosity >= 2:
            self._print(f"Info: finished itime = {self.itime:7d}, "
                        f"time = {self.time:9.3f}")
        if self.cfg.verbosity >= 3:
            self._print(
                "Info: diagnostics: "
                f"int E^2 dx = {float(eng.field):.6e}; "
                f"marker KE = {np.array2string(np.asarray(eng.marker), precision=6)}; "
                f"total KE = {np.array2string(np.asarray(eng.total), precision=6)}; "
                f"pertb KE = {np.array2string(np.asarray(eng.pertb), precision=6)}; "
                f"live markers = {np.asarray(nlive).tolist()}; "
                f"mode_re = {np.array2string(np.asarray(mode_re), precision=6)}; "
                f"mode_im = {np.array2string(np.asarray(mode_im), precision=6)}")
