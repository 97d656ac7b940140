"""Static per-simulation configuration.

Counterpart of the reference's compile-time features + runtime resources that
are fixed per simulation (``SolverConfig`` ``src/dynamics/solver/plugin.rs:216-302``,
``NarrowPhaseConfig`` ``src/collision/narrow_phase/mod.rs:203-255``,
``SubstepCount`` ``src/dynamics/solver/schedule.rs:185-191``).

Everything here is a frozen dataclass of Python scalars. The port runs
eagerly, so nothing is compiled against these values: each stage reads them
on the host every step and hands them to its kernels as scalar arguments,
and a changed value takes effect at the next ``physics_step``. The field
names and defaults are the JAX package's, so that one config describes the
same simulation in both. Per-scene *dynamic* knobs (gravity, materials)
live in the ``World`` instead.
"""

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class SolverConfig:
    """Contact solver tuning. Defaults mirror the reference's
    ``SolverConfig::default`` (``plugin.rs:291-302``)."""

    contact_damping_ratio: float = 10.0
    contact_frequency_factor: float = 1.5
    max_overlap_solve_speed: float = 4.0
    warm_start_coefficient: float = 1.0
    restitution_threshold: float = 1.0
    restitution_iterations: int = 1
    # Tangential relative speed (in length_units/s) below which the STATIC
    # friction coefficient bounds the friction impulse instead of the
    # dynamic one (stiction). The reference's ``Friction`` carries both
    # coefficients (``physics_material.rs:137-146``) though its v0.4.1
    # solver consumes only the dynamic one; here the split is honored.
    static_friction_speed_threshold: float = 0.1

    def replace(self, **kw):
        return replace(self, **kw)


@dataclass(frozen=True)
class NarrowPhaseConfig:
    """Narrowphase tuning. Defaults mirror ``NarrowPhaseConfig``
    (``narrow_phase/mod.rs:203-245``): unbounded speculative margin,
    contact tolerance 0.005 * length_unit, contact matching on."""

    default_speculative_margin: float = float("inf")
    contact_tolerance: float = 0.005
    match_contacts: bool = True
    # Warm-start positional match threshold when feature ids are unknown
    # (0.1 * length_unit, reference ``system_param.rs:788``).
    match_distance: float = 0.1


@dataclass(frozen=True)
class PhysicsConfig:
    """Top-level static physics configuration.

    Capacities are *not* stored here — they are implied by the World's array
    shapes.
    """

    dt: float = 1.0 / 60.0
    substeps: int = 6  # SubstepCount default (solver/schedule.rs:185-191)
    length_unit: float = 1.0  # PhysicsLengthUnit (plugin.rs:160-207)
    solver: SolverConfig = field(default_factory=SolverConfig)
    narrow_phase: NarrowPhaseConfig = field(default_factory=NarrowPhaseConfig)

    # --- Scheduling knobs of the data-parallel solver (no Avian counterpart) ---
    # Maximum constraint-graph colors; edges that don't fit fall into the
    # final color, solved with an under-relaxed (averaged-Jacobi) update.
    # The reference uses 24 greedy colors + a serial overflow color
    # (``constraint_graph.rs:39-48``). Settled piles need >= max body
    # contact degree assignable colors for the overflow to stay near-empty.
    max_colors: int = 12
    # Per-color bucket capacity = factor * C / max_colors. Colors are rarely
    # balanced (ground contacts don't conflict and crowd one color), so >1.
    # Overflowing constraints fall into later buckets or are dropped
    # (counted in ``ContactConstraints.overflow_dropped``).
    color_bucket_factor: float = 2.0
    # Sweep-and-prune candidate window: after sorting colliders by AABB min-x,
    # each collider is tested against the next `sap_window` colliders. Wider
    # windows cost compute; overlaps beyond the window are missed (counted in
    # diagnostics as dropped pairs). The reference takes at most 32; the port
    # up to 64 (Kernel B's 64-bit candidate mask), which a crowded grid cell
    # such as the terrain's needs.
    sap_window: int = 32
    # Sleeping thresholds (rigid_body/sleeping.rs:84-97, :149-152).
    sleep_linear_threshold: float = 0.15
    sleep_angular_threshold: float = 0.15
    time_to_sleep: float = 0.5
    sleeping_enabled: bool = True
    # All-asleep early-out: when every active dynamic body sleeps (and no
    # kinematic body moves, no sleeping body was teleported), the whole
    # step is skipped by a host-side branch on one device-to-host read: the
    # analogue of the reference popping sleeping islands' constraints and
    # doing no work for them (``islands/sleeping.rs:355-426``).
    sleep_early_out: bool = True
    # Swept CCD pass for bodies flagged ``swept_ccd`` (SweptCcd component,
    # ``ccd/mod.rs:389-419``). Off by default like the reference; speculative
    # contacts are always on.
    swept_ccd: bool = False
    # Optional static hint: canonical (type_a, type_b) shape pairs the scene
    # can produce (``SceneBuilder.shape_pairs()``). The narrowphase dispatch
    # only evaluates these pairs; a pair outside the hint gets the empty
    # manifold. None = all supported pairs.
    shape_pairs: tuple | None = None
    # NaN quarantine: when True (default) a step that would produce
    # non-finite body state instead freezes the world and sets
    # ``World.diverged`` — the reference's debug finite-state assertions
    # (``schedule/mod.rs:295-321``) turned into a recoverable per-scene
    # mask for batched rollouts (SURVEY.md par.5 failure recovery).
    nan_guard: bool = True
    # Max bodies swept per step by the opt-in swept-CCD pass (the TOI
    # columns are computed only for flagged colliders, O(K x M) instead of
    # the reference's per-entity loop / round 1's O(M^2)).
    max_swept_colliders: int = 32

    @property
    def substep_dt(self) -> float:
        return self.dt / self.substeps

    def replace(self, **kw):
        return replace(self, **kw)
