#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the root of a checkout; one card, nvcc

It drives twenty-five paths, each through ``exahype_tpu_torch``'s entry points
with its kernels' launch counters set to 0 just before and read just
after (the two forms of the main path, ADER-DG and FV, and the order-4, -5
and -7,
limited, limited with walls, limited 2-D blast with walls, viscous shock,
2-D vortex, 2-D Navier–Stokes walls and order 2, CK, layered seismic, homogeneous elastic, walls, viscous,
dynamic-GR, shifted
dynamic-GR, Z4+GRHD, limited Z4+GRHD and Z4+GRMHD slices, and the sharded
steps of the multichip phase), in this order:

- **ADER-DG**: ``bench.py::main``'s step — order 3, 3-D compressible
  Euler, a ``(256, 8, 128)`` periodic cell grid in float32, ``bench.py``'s
  initial state — through ``CudaADERDG`` (kernels of ``csrc/aderdg.cu``).
  The time step is the solver's own ``cfl_dt`` of the initial state
  (6.26e-5), not ``bench.py``'s fixed 1e-4: that is 1.6x over the CFL limit
  at dx = 1/256, and on this rough state the step then amplifies until the
  state overflows.  The JAX solver does the same on cut grids
  (``tests/test_torch_slice.py::test_bench_dt_blows_up_in_both_packages``);
  the script records the step at which the port overflows at the bench
  grid.
- **ADER-DG p4, p5, p7**: 3-D compressible Euler at orders 4, 5 and 7
  (``ST_ORDERS``' note) — order 5 ``examples/high_order_p5.py``'s step
  (periodic, dx = 1/g0, dt = 2e-5, from the example's exact density wave, γ
  = 1.4, p0 = 2, velocity (1, 0.5, 0.25), made periodic along the short
  axes), orders 4 and 7 the same wave at ``cfl_dt`` — through
  ``CudaADERDG`` (K1 c: ``aderdg_predictor_volume_pN``, the space-time
  predictor of ``csrc/aderdg_st.cuh``, and the face stage's n = 5, 6, 8
  instances ``aderdg_face_flux_pN`` + ``aderdg_surface_update_pN``, or with
  walls ``aderdg_face_flux_walls_pN`` + ``aderdg_surface_update_walls_pN``),
  three launches a step: each kernel against its plain version in float64
  on a cut grid (at two dt, within 1e-12 of max(1, max|plain|), periodic and
  in every wall mode) and in float32 at full width (``ST_GRIDS``: order 4
  ``(128, 8, 128)``, order 5 the example's ``(32, 4, 128)`` and ``(64, 8,
  128)``, order 7 ``(32, 8, 128)`` and ``scripts/mxu_probe.py``'s ``(16, 4,
  32)``); 10 steps at each with the example's gates (error against the
  exact wave below 5e-3, mass drift below 1e-5), bitwise repeatable and
  against the plain path; at each order's first grid a reflective box
  (mass and energy within 1e-5, momentum moved), an outflow and a farfield
  channel on axis 0; times and ``[kernel]`` lines; and the order anchor:
  the exact wave in float64 through the kernels of orders 3, 4, 5 and 7 on
  one cut grid, the error falling from order to order.
- **limited**: ``bench.py::bench_limited``'s production step — the same
  solver, grid and dtype, ``LimitedADERDG(admissible=euler_admissible(3),
  troubled_capacity=128, troubled_granularity="row", dmp_delta0=5e-4,
  accelerator=CudaADERDG(solver), subcell_cuda=True)`` with the "means"
  overflow policy and the post-step guard, from the bench's Sod shock along
  axis 0 at the bench's dt = 1.5e-4 (``bench.py:326-356``): 5 warm-up steps
  (the bench's first chunk), then 10 checked ones.  Its kernels are three
  of ``csrc/aderdg.cu`` (the predictor and the face stage's two launches,
  which also return the face fluxes) and the subcell sweep (K3) of
  ``csrc/subcell.cu``, six launches a step.
- **limited walls**: the same production step with reflective walls on
  axis 0 (``wall_axes=(0,)``, ``euler_reflect``/``euler_reflect_flux``):
  the face stage's wall pair (``aderdg_face_flux_walls`` +
  ``aderdg_surface_update_walls``) and K3 on ghosts that mirror at the
  walls, from the Sod state with a uniform u_x = 0.5 added (``WALLS_UX``:
  the reflection at the high wall troubles wall rows from the first step),
  dt = 1.5e-4, 5 warm-up and 10 checked steps.  Gates: the limited path's
  (admissibility, rows demanded against the capacity, one step's masks
  and state against the plain path, the poison check, bitwise
  repeatability, six launches a step), mass and energy drift under 1e-5,
  troubled rows at a wall on every checked step (``[limited walls]``);
  in float64 at ``(8, 4, 8)`` the candidate's face fluxes slot for slot
  in every wall mode, and limited steps with reflective, outflow and
  farfield walls against the plain limiter at 1e-12.
- **limited blast walls**: ``examples/limited_blast_walls.py`` — 2-D p3
  Euler in a reflective box, ``LimitedADERDG(admissible=euler_admissible(2),
  accelerator=CudaADERDG(solver))`` with the whole-grid subcell fallback
  (eager PyTorch), the pressurised disc — through K1 c's 2-D instance
  (``csrc/aderdg_2d.cu``: ``aderdg_predictor_volume_2d`` and the wall pair
  ``aderdg_face_flux_walls_2d`` + ``aderdg_surface_update_walls_2d``, three
  launches a step): the example's ``(16, 16)`` at dt = 2.5e-4 over its 20
  steps with its gates (admissible, mass and energy drift under 1e-5,
  cells troubled on step 1), then ``(1024, 1024)`` at ``cfl_dt`` over 10
  steps with the same gates, repeatability, one step's masks and state
  against the plain path, the periodic twin (the periodic pair
  ``aderdg_face_flux_2d`` + ``aderdg_surface_update_2d``), times and
  ``[kernel]`` lines; every 2-D kernel against its plain version launch by
  launch in float64 at ``(8, 8)`` (periodic and every wall mode, a
  Dirichlet box from ``make_dirichlet_fn`` included) and in float32 at
  ``(1024, 1024)``; the whole-grid ``fallback="means"`` and the Dirichlet
  whole-grid step against the plain limiter in float64.
- **viscous shock**: ``examples/viscous_shock.py`` — 2-D p3 compressible
  Navier–Stokes (μ = 5e-3, Pr = 0.7), periodic, the shock-tube slab,
  ``LimitedADERDG(admissible=euler_admissible(2), fallback_order=2,
  accelerator=CudaADERDG(solver))`` with the whole-grid MUSCL fallback and
  its diffusive face fluxes (eager PyTorch) — through K1 c's 2-D
  Navier–Stokes instance (``csrc/aderdg_2d.cu``:
  ``aderdg_predictor_volume_visc_2d`` and the periodic pair's viscous
  instance ``aderdg_face_flux_2d`` + ``aderdg_surface_update_2d``, three
  launches a step): the example's ``(64, 4)`` in float64 at half the
  viscous ``cfl_dt`` over its 120 steps for μ = 0 (the 2-D Euler kernels)
  and μ = 5e-3 with its gates (drift below 1e-12, admissible, the limiter
  fired, the two runs differ by more than 1e-5) and 3 steps against the
  plain limiter, then ``(1024, 1024)`` in float32 over 10 steps with the
  gates, repeatability, one step's masks and state against the plain path,
  the stages' times, the idle share, the peak memory and ``[kernel]``
  lines; the kernels against their plain versions launch by launch in
  float64 at ``(8, 8)`` and ``(64, 4)`` on a noisy state and in float32 at
  ``(1024, 1024)``.
- **2-D vortex**: ``examples/navier_stokes_vortex.py`` — the periodic 2-D
  Taylor–Green vortex on the same kernels through ``CudaADERDG``, float64:
  the example's ``(32, 32)`` over T = 0.25 (the kinetic energy's decay
  rate within 2e-2 of 4ν(2π)², drift below 1e-11) and ``(1024, 1024)`` over
  10 steps at ``cfl_dt`` (the decay against 1 − exp(−4ν(2π)²t)), timed.
- **2-D Navier–Stokes walls and order 2**: the solvers of the JAX
  package's viscous-wall tests (``tests/test_navier_stokes.py:387-503``) and
  Pallas Navier–Stokes tests (``:237-268``, ``tests/test_parallel.py:888-928``)
  through ``CudaADERDG`` (``csrc/aderdg_2d.cu``: the viscous predictor with
  the wall planes and the walled face pair with the advective/viscous wall
  split at order 3, and the order-2 instances ``*_p2_2d``, periodic and
  walled; three launches a step): every new kernel against its plain
  version launch by launch on ``NS2W_CUT`` in every wall mode (float64 at
  atol 1e-12, float32 for the periodic solver and the no-slip box at both
  orders, 3-step reruns bitwise); the JAX tests' anchors
  on the kernels in float64 (the no-slip channel's decay at ν π² within 2e-2
  at ``(8, 8)`` and ``(16, 16)``, the order-2 box's mass to 1e-12 and kinetic
  energy below 0.8 after 160 steps, outflow walls equal to the periodic run
  to 1e-12 over 3 steps); ``NS2W_RUNS`` at ``(1024, 1024)`` in float32 (the
  order-3 periodic step beside the no-slip channel, outflow and no-slip box
  at order 3 and the periodic and no-slip box at order 2: launches, finite,
  bitwise reruns, step and predictor times; the kernels of the last three
  against plain in float32 on the timed state) and ``[kernel]`` lines.
- **CK**: ``bench.py::bench_ck``'s step — order 3, 3-D heterogeneous
  elasticity (12 variables: velocity–stress and frozen per-node ρ, λ, μ),
  ``predictor_mode="ck"``, ``ck_material_slots=(9, 10, 11)``,
  ``dissipation_mask=(1,)*9 + (0, 0, 0)``, dx = 1/g0, the plane P wave in a
  two-layer medium (``bench.py:167-204``), float32 — through ``CudaADERDG``
  (the CK predictor K2 and the face stage's two kernels of
  ``csrc/aderdg.cu``), three launches a step.  Two grids: the bench's ``(64, 4, 32)`` at its dt = 2e-4
  over its window (5 warm-up steps, then 40) with its integrity checks
  (finite, slots 9–11 bitwise frozen, seismic energy ratio below 1.02),
  and ``(256, 8, 128)``, the same problem at 4x the resolution, 10 steps at
  ``cfl_dt`` (2e-4 is over the CFL limit at dx = 1/256).
- **seismic**: ``examples/seismic3d_layered.py`` — the same CK system in a
  two-layer medium (ρ, λ, μ = 1, 2, 1 above half depth, 1.2, 9.6, 4.8
  below) with the free surface on axis 2, the absorbing sponge on axes 0
  and 1 (``sponge_source(width=0.12, rate=40, n_wave=9)``), a vertical
  Ricker point force (f0 = 8) at depth and four surface receivers, dt =
  ``cfl_dt`` at cfl 0.15, half the example's (at the example's dt this
  step diverges in both packages: ``SEIS_CFL``) — Strang-split
  ``PointSources.step`` around ``CudaADERDG.step`` (K2 a,
  ``aderdg_ck_predictor_volume_sponge``, and the walled face pair: three
  launches a step), ``TracerAdvector.sample`` after each step, the time a
  0-d tensor and the seismogram on the card.  In float64 at the example's
  ``(9, 9, 6)``: K2 a against its plain version (``new`` and the face
  projections, on a state with seeded noise on the wave rows, within 1e-12
  of max(1, max|plain|), at both dt), the walled face stage launch by
  launch, 5 forced steps of the kernel path against the plain path at the
  same bar, the run to the example's time (160 steps) with its gates and
  on to 240 steps, past the P arrival, where its arrival gate applies; in
  float32 at ``(63, 63, 36)``: 800 steps (the example's time) with its
  gates (finite, materials bitwise frozen, mirror symmetry across the
  source axis below 1e-5 of the field's maximum), on to 1,600 steps where
  its P-arrival gate applies, 3 launches a step, two runs bitwise equal;
  K2 a against its plain version and 10 forced steps against the plain
  path, both on the step-800 field with seeded noise on the wave rows,
  over every cell and over the sponge's cells alone (each limit from its
  own max|plain|; the sourceless kernel must miss the sponge cells'); as
  readings, K2 a's time beside the sourceless
  K2's on the same state and its bound, the forced step's time, the inject
  and sample times, the idle share, the peak memory and the host
  synchronisations of a step.
- **elastic K2 b**: the homogeneous elasticity on the CK kernels (K2 b,
  the CK predictor a thread a space node, ``csrc/aderdg_ck_nodes.cuh``).
  3-D: ``elastic3d`` at order 2, periodic, ``(256, 8, 128)`` in float32
  (``aderdg_ck_predictor_volume_p2`` and the face stage's n = 3 instances
  ``aderdg_face_flux_p2`` + ``aderdg_surface_update_p2``): the kernels
  against plain in float64 at two cut grids and in float32 at full width
  on seeded noise, 10 steps of the plane P wave at ``cfl_dt`` (cfl 0.15)
  against the plain path and the exact wave, bitwise repeatable, 3
  launches a step, the growth at the default cfl and at 0.3 as a reading;
  times, idle share, ``[kernel]`` lines.  2-D:
  ``examples/seismic_point_source.py --ck`` (``aderdg_ck_predictor_volume_2d``
  and the walled 2-D face pair over ``Elastic2D``, ``csrc/aderdg_2d.cu``) on
  the odd grid ``(129, 129)`` in float32 for 1,200 Strang-split forced steps
  with the receivers sampled after each, the example's mirror and P-arrival
  gates, 3 launches a step, bitwise repeatable, 10 steps against the plain
  path; the example's own ``(128, 128)``/400 steps as a reading; the kernels
  against plain in float64 at two cut grids (periodic and free surface) and
  in float32 at ``(1024, 1024)``, where the forced step is timed.
- **walls**: domain walls on the ADER-DG step — the face stage's wall
  variant (``aderdg_face_flux_walls`` + ``aderdg_surface_update_walls``)
  against the plain ``face_update`` in float64 at ``(8, 4, 8)`` in every
  mode (Euler: a reflective box, outflow and farfield walls on axis 0, a
  Dirichlet box with rows from ``make_dirichlet_fn``, reflective walls on
  axes 1 and 2; the CK free surface on axis 2), then at ``(256, 8, 128)``
  in float32, 10 steps at ``cfl_dt``: ``bench.py``'s Euler state in a
  reflective box (mass and energy drift under 1e-5, momentum changed,
  repeatable, the plain path), a uniform supersonic flow equal to the
  farfield state in a farfield channel on axis 0 (steady within the
  float32 bound), and ``bench_ck``'s problem with the free surface
  (materials bitwise frozen, energy ratio below 1.02, the plain path);
  the walled step timed beside the periodic one.
- **viscous**: compressible Navier–Stokes (``models/navier_stokes.py``)
  on the ADER-DG step through ``CudaADERDG`` — the viscous predictor
  ``aderdg_predictor_volume_visc`` (``csrc/aderdg_visc.cu``) and the face
  stage with the Gassner penalty (and on walls the advective/viscous split)
  against plain in float64 on ``(8, 4, 8)`` (periodic, no-slip and outflow
  walls on axis 0, μ = 0.02, Pr = 0.7), then the 3-D Taylor–Green vortex
  at ``(64, 64, 64)`` p3 in float32 (Re = 1600, Mach 0.1, Pr = 0.71 on the
  unit box), periodic and with no-slip walls on axis 0, against plain at
  full width and 10 steps at ``cfl_dt`` (finite; mass and, periodic,
  energy within 1e-5, momentum moved by less than 1e-5 of the mass, the
  kinetic energy down at every step; walled, no mass through the walls and
  the kinetic energy down; repeatable; 3 launches a step), both timed, and
  the decay anchors in float64 (a shear mode at ν(2π)², the no-slip
  channel mode at νπ², within 2e-2).
- **FV**: the spec-DSL Rusanov patch update of ``__graft_entry__.py`` —
  ``build_fv_rusanov_kernel`` (3-D Euler, patch 4, halo 1, 5 vars) →
  ``TpuPatchGrid`` → ``GridSolver(kernel_dt="lambda")`` with ``compute_dt``
  every step (cfl 0.45, dx = 1/(4·g0)), float32, at ``(8, 8, 128)`` (the
  JAX package's own FV measurement size) and ``(32, 16, 128)`` patches,
  from ``__graft_entry__._example_state``'s recipe.  Its kernel (K4) is
  generated from the spec's statement list (``backends/cuda_backend.py``).
- **Z4**: ``scripts/z4_probe.py --large --pallas``'s step — the 38-variable
  vacuum Z4 system, order 2, 3-D, ``make_z4_solver(impl="soa",
  fused_rhs="soa")`` (harmonic slicing f = 1, m = 2, κ₁ = κ₂ = 0) on a
  ``(16, 16, 128)`` grid at dx = 1/128, the exact gauge wave of amplitude
  0.1, float32, dt = 1e-4 (0.18x ``cfl_dt``) — through ``CudaADERDG``, the
  counterpart of ``PallasADERDG`` over that solver: the Picard predictor
  with the algebra compiled in (K1 d, ``csrc/aderdg_z4.cu``) and its face
  stage with the NCP half-fluctuations, 3 launches a step; and, still,
  through ``with_cuda_rhs``, which puts only the fused right-hand side on
  K5 (``csrc/rhs.cu``): 3 Picard and 2 corrector launches a step, the
  source and the face NCP evaluations eager PyTorch, as the JAX solver
  keeps them in XLA.
- **Z4 shifted**: ``scripts/z4_probe.py --shift --large``'s system — the
  53-variable shifted Z4 system with the Gamma-driver (f_b = 0.75, η = 1;
  harmonic slicing), ``make_z4_shift_solver(fused_rhs="soa")``, on the
  same grid from the moving gauge wave (v = 0.2, amplitude 0.1), dt = 1e-4
  (0.205x ``cfl_dt``), float32 — through ``CudaADERDG`` (K1 d's shifted
  instance, ``csrc/aderdg_z4_shift.cu``: ``aderdg_*_z4_shift``, 3 launches
  a step) and through ``with_cuda_rhs`` (K5 c, ``rhs_all_z4_shift``).  Its
  kernels are held to their plain versions on states with seeded noise
  on every slot (``Z4S_NOISE``: on the exact moving wave b = B = 0), in
  float64 at ``(8, 4, 16)`` for a Gamma-driver family with 1+log slicing
  (``Z4S_FAMILIES``) and in float32 at full width; its readings
  add max|β − v| and max|b| (the Gamma-driver must move both).
- **Z4+GRHD**: ``scripts/z4_probe.py --matter --large --pallas``'s system —
  the 43-variable coupled Z4 + general-relativistic hydro system (geodesic
  slicing: harmonic, f = 0; Γ = 5/3; the recovery's 10 Newton trips),
  ``make_z4_matter_solver(fused_rhs="soa")``, on ``Z4_GRID`` from
  ``examples/flrw_cosmology.py``'s FLRW slice (ρ₀ = 0.02, ε₀ = 0.4) with the
  probe's 5 % perturbation of D̃ and τ̃ along axis 2, dt = 1e-4 (0.17x
  ``cfl_dt``), float32, 5 warm-up steps and 10 checked ones — through
  ``CudaADERDG`` (K1 d's conservative-flux variant over ``Z4Matter``,
  ``csrc/aderdg_z4_matter.cu``: ``aderdg_*_z4_matter``, 3 launches a step)
  and through ``with_cuda_rhs`` (K5 d, ``rhs_all_z4_matter``, con2prim in
  the kernel).  Its kernels are held to their plain versions on a fluid
  with a velocity field and seeded noise on every Z4 slot (``Z4M_NOISE``)
  in float64 at ``(8, 4, 16)`` in the kernels' other branches
  (``Z4M_FAMILIES``) and in float32 at full width; its gates add admissibility
  (``z4_matter_admissible``), ∫D̃ dV conserved within ``Z4M_DRIFT``, and the
  exact homogeneous FLRW universe after 10 steps against the Friedmann
  reference (``flrw_reference``: a², D̃, |Θ|, |Z|).
- **limited Z4+GRHD**: the same solver and FLRW slice (no sine) with a
  one-cell clump of D̃ and τ̃ at the box centre (``Z4L_AMP``, ``Z4L_WIDTH``:
  ``tests/test_z4_matter.py:503-543``'s profile, as sharp relative to a
  cell), ``LimitedADERDG(admissible=z4_matter_admissible(),
  troubled_capacity=128, troubled_granularity="row",
  accelerator=CudaADERDG(solver), subcell_cuda=True)``, dt = 1e-4, 5
  warm-up and 10 checked steps, the troubled rows printed at each — through
  K1 d's three Z4+GRHD kernels and K3 a's Z4+GRHD p2 instance
  (``subcell_row_sweep_z4_matter``: ``csrc/subcell_ncp.cuh``, built by
  ``csrc/subcell_z4_matter.cu``), three launches a step each; the source
  after the sweeps stays plain PyTorch.  K3 a is held to the plain sweep
  direction by direction in float64 at ``Z4_CUT`` with every slot active
  on a noisy state (``Z4M_NOISE``) at 1e-12 of max(1, max|plain|), and in
  float32 on the main path's gathered batch; the gates add
  admissibility, ∫D̃ dV within ``MASS_RTOL`` when no overflow engaged, one
  step against the plain limited step (equal troubled masks, the float32
  bound) and bitwise repeatability.
- **Z4+GRMHD**: the ExaGRyPE flagship shape of
  ``exahype_tpu/models/z4_grmhd.py`` — the 47-variable coupled Z4 + ideal
  GRMHD system with GLM cleaning (geodesic slicing: harmonic, f = 0; Γ =
  5/3; the recovery's 20 Newton trips; c_h = 1, κ = 0.5),
  ``make_z4_grmhd_solver(fused_rhs="soa")``, on ``Z4_GRID`` from the
  magnetized wave of the JAX tests with one period along axis 0, dt = 1e-4,
  float32, 5 warm-up steps and 10 checked ones — through ``CudaADERDG``
  (K1 d's conservative-flux variant over ``Z4Grmhd``,
  ``csrc/aderdg_z4_grmhd.cu``: ``aderdg_*_z4_grmhd``, 3 launches a step)
  and through ``with_cuda_rhs`` (K5 e, ``rhs_all_z4_grmhd``, the
  field-aligned con2prim in the kernel) for ``Z4_EAGER_STEPS``.  Its
  kernels are held to their plain versions on a magnetized fluid with
  seeded noise on every Z4 slot (``Z4G_NOISE``) in float64 at ``(8, 4,
  16)`` in the kernels' other branches (``Z4G_FAMILIES``) and in float32
  at full width;
  its gates add admissibility (``z4_grmhd_admissible``), ∫D̃ dV and each
  ∫B̃^i dV conserved within ``Z4G_DRIFT``, and with B̃ = φ̃ = 0 one float64
  kernel step against the Z4+GRHD kernels' (``Z4G_ZERO_FIELD_TOL``).
- **Z4 per-axis and 2-D**: the vacuum Z4 system as the JAX package builds
  it by default (``make_z4_solver(..., fused_rhs=False)``, the per-axis
  NCP: ``tests/test_z4.py:497-529``, ``__graft_entry__.py:483-503``) and in
  2-D — through ``CudaADERDG``: K1 d's per-axis predictor on the 3-D cell
  (``csrc/aderdg_z4_per_axis.cu``) with the fused step's face pair on
  ``Z4_GRID``, and the 2-D steps at orders 2 and 3, fused and per-axis
  (``csrc/aderdg_z4_2d.cu``, ``aderdg_z4_2d_p3.cu``) on ``Z4F_GRID``, 3
  launches a step, on the gauge wave of amplitude 0.1 with seeded noise
  (``Z4F_NOISE``), dt = 1e-4, float32.  Each kernel is held to its plain
  version in float64 on ``Z4F_CUT`` (3-D: ``Z4_CUT``) and in float32 at
  full width; the steps repeat bitwise; the 3-D per-axis step is timed
  beside the fused one and the 2-D fused step beside one eager step of K5
  b's ``with_cuda_rhs`` route on the same state.  ``examples/
  z4_gauge_wave.py`` (order 3, per-axis) runs on its chip grid ``(64, 2)``
  for 256 steps in float64 against its chip gates and in float32 as a
  reading (over the gates in both packages: ROADMAP.md Queue 3), and in
  its CPU configuration (8 cells, 32 steps, float64) against its CPU
  gates, each one step against the plain path.
- **Z4+GRHD per-axis and 2-D**: the coupled system as the JAX package
  builds it by default (``make_z4_matter_solver(..., fused_rhs=False)``,
  ``exahype_tpu/models/z4_matter.py:305-357``) in 3-D and 2-D, and its fused
  2-D step, order 2, geodesic slicing — through ``CudaADERDG``: K1 d's
  per-axis predictor with the hydro flux on the 3-D cell
  (``csrc/aderdg_z4_matter_per_axis.cu``) with the fused Z4+GRHD step's
  face pair on ``Z4_GRID``, and the 2-D step, fused and per-axis
  (``csrc/aderdg_z4_matter_2d.cu``) on ``Z4F_GRID``, 3 launches a step, 5
  steps from the perturbed FLRW slice, dt = 1e-4, float32; and K5 b's
  Z4+GRHD instance (``rhs_all_z4_matter_2d``) under the 2-D fused
  solver's ``with_cuda_rhs`` route.  Each kernel is held to its plain
  version on a moving fluid with seeded noise on every Z4 slot in float64
  on ``Z4F_CUT`` (3-D: ``Z4_CUT``) in ``Z4M_FAMILIES`` and in float32 at
  full width; the steps repeat bitwise; the 3-D per-axis step is timed
  beside the fused one and the 2-D fused step beside one eager K5 b step
  on the same state.  ``examples/flrw_cosmology.py`` (2-D, per-axis, its
  FLRW universe, 100 steps to t = 0.5) runs on its ``(4, 4)`` and on ``(256,
  256)`` at its dx and dt, its bars (``Z4MX_BARS``) gated in float64 and
  read in float32, the float64 runs one step against the plain path.
- **Z4+GRMHD per-axis and 2-D**: the magnetized system as the JAX package
  builds it by default (``make_z4_grmhd_solver(..., fused_rhs=False)``,
  the solver of every Z4+GRMHD test there) in 3-D and 2-D, and its fused
  2-D step, order 2, the Z4+GRMHD path's gauge and cleaning — through
  ``CudaADERDG``: K1 d's per-axis predictor with the matter flux on the
  3-D cell (``csrc/aderdg_z4_grmhd_per_axis.cu``) with the fused Z4+GRMHD
  step's face pair on ``Z4_GRID``, and the 2-D step, fused and per-axis
  (``csrc/aderdg_z4_grmhd_2d.cu``) on ``Z4F_GRID``, 3 launches a step, 5
  steps from the magnetized wave (a field nowhere zero), dt = 1e-4,
  float32, gated on finiteness, admissibility at every node and the drift
  of ∫D̃ and each ∫B̃^i dV; and K5 b's Z4+GRMHD instance
  (``rhs_all_z4_grmhd_2d``) under the 2-D fused solver's ``with_cuda_rhs``
  route.  Each kernel is held to its plain version on a magnetized fluid
  with seeded noise on every Z4 slot in float64 on ``Z4F_CUT`` (3-D:
  ``Z4_CUT``) in ``Z4G_FAMILIES`` and in float32 at full width; with B̃ =
  φ̃ = 0 each form's float64 step is the Z4+GRHD kernels' (the float32
  recovery is NaN at a zero field in both packages); the steps repeat
  bitwise; the 3-D per-axis step is timed beside the fused one and the
  2-D fused step beside one eager K5 b step on the same state.
- **Z4 shifted per-axis and 2-D**: the 53-variable shifted system as the
  JAX package builds it by default (``make_z4_shift_solver(...,
  fused_rhs=False)``, the per-axis NCP: the solver of every shifted test
  there and of ``scripts/z4_probe.py --shift --large``'s per-axis runs) in
  3-D and 2-D, and its fused 2-D step, order 2, the Gamma-driver of the
  shifted path — through ``CudaADERDG``: K1 d's per-axis predictor over the
  shifted system on the 3-D cell (``csrc/aderdg_z4_shift_per_axis.cu``)
  with the fused shifted step's face pair on ``Z4_GRID``, and the 2-D step,
  fused and per-axis (``csrc/aderdg_z4_shift_2d.cu``) on ``Z4F_GRID``, 3
  launches a step, 5 steps from the moving gauge wave (v = 0.2, amplitude
  0.1) with seeded noise on every slot, dt = 1e-4, float32, gated on
  finiteness and a bitwise rerun; and K5 b's shifted instance
  (``rhs_all_z4_shift_2d``) under the 2-D fused solver's ``with_cuda_rhs``
  route.  Each kernel is held to its plain version on that noisy wave in
  float64 on ``Z4F_CUT`` (3-D: ``Z4_CUT``) in ``Z4S_FAMILIES`` and in
  float32 at full width; the JAX package's three
  shifted anchors (``tests/test_z4.py:802-860``: flat space with a constant
  shift stationary to 1e-13 in both modes, the moving wave's convergence
  rate above 2.5, the Gamma-driver's noise bounded below 1e-4 after 40
  steps) run in float64 through the 2-D per-axis kernels; the 3-D
  per-axis step is timed beside the fused one and the 2-D fused step
  beside one eager K5 b step on the same state.
- **multichip**: the sharded steps of ``exahype_tpu_torch/parallel/shard.py``
  (the twin of the JAX package's ``shard_map`` steps, ``__graft_entry__.py::
  dryrun_multichip``'s configurations at the bench's widths).  K1 e
  (``aderdg_face_flux_exchanged`` + the walled update) against its plain
  version (``shard.exchanged_face_surface``) in float64 at ``MC_CUT`` in
  every wall mode, each axis cut into 1 and 2 windows with the walls on the
  windows owning them, and bitwise the unsharded face stage on every window;
  in float32 at ``GRID``; K5 b (``rhs_all_z4_2d``) on every call of a step
  of the 2-D gauge wave, float64 at ``MC_Z4_CUT`` and float32 at
  ``MC_Z4_GRID``.  Then, at world size 1 over NCCL in this process (meshes
  ``(1,)`` and ``(1, 1)``) and with ``MC_RANKS`` spawned ranks sharing the
  card over gloo (meshes ``(4,)`` and ``(2, 2)``): ``bench.py::main``'s
  ADER-DG step at ``cfl_dt`` periodic, reflective on axis 0 and outflow on
  axes 0 and 1 (``MC_DG_CASES``, ``MC_DG_STEPS`` steps), the FV step at
  ``MC_FV_GRID`` with the global dt (its MIN all-reduce) on both meshes, and
  the 2-D Z4 step through K5 b (``MC_Z4_STEPS``), each gathered on rank 0
  and bitwise the unsharded step, with the launches per step counted on
  every rank.  Readings at world size 1: the sharded step's host windows
  beside ``CudaADERDG.step``'s, K1 e's flux and pair and the pack and
  exchange (CUDA events), ``[kernel]`` lines.  The 4-rank run prints no
  time (the ranks share one card: no scaling figure).

Phases:

1. card: name, and ``nvidia-smi``'s name and power limit;
2. build: ``csrc/aderdg.cu``, ``csrc/aderdg_2d.cu``, ``csrc/aderdg_p4.cu``,
   ``csrc/aderdg_p5.cu`` and ``csrc/aderdg_p7.cu`` (float32) and their
   ``_f64`` twins, ``csrc/aderdg_visc.cu`` and
   ``csrc/aderdg_visc_f64.cu``, ``csrc/aderdg_z4.cu`` and
   ``csrc/aderdg_z4_f64.cu``, ``csrc/aderdg_z4_shift.cu`` and
   ``csrc/aderdg_z4_shift_f64.cu``, ``csrc/aderdg_z4_matter.cu`` and
   ``csrc/aderdg_z4_matter_f64.cu``, ``csrc/aderdg_z4_grmhd.cu`` and
   ``csrc/aderdg_z4_grmhd_f64.cu``, the Z4 systems' per-axis and 2-D sources
   (``csrc/aderdg_z4*_per_axis*.cu``, ``csrc/aderdg_z4*_2d*.cu``),
   ``csrc/subcell.cu``, ``csrc/rhs.cu`` and the
   K4 sources of the ``fv`` and the canonical ``rusanov`` spec, one
   ``nvcc`` each, all started together (time, source hash, nvcc seconds
   per source, and ptxas's registers/shared memory/spills);
3. each kernel against its plain PyTorch version on the card: float64 at
   atol=1e-12 (ADER-DG, its face fluxes and the CK kernels ``(8, 4, 32)``;
   K3 a batch of ``K=8, L=16`` rows per direction with 3 and 8 slots
   active; K4 ``(2, 2, 2)``, both specs), float32 at each path's full shape
   (K3 on the gathered batch of the limited path after its warm-up, at its
   own ``n_active`` and with every slot active; CK at both grids, the evolved and
   the material rows each against their own largest value; K5 on the
   first Picard call and the corrector's, also against the float64 plain
   result) at the bound stated in ``F32_ULPS``; K3 in place, its active
   slots against the plain sweep, its inactive slots bitwise untouched with
   zero edge fluxes, bitwise repeatable with dt by value and by pointer; K4
   with ``SENTINEL`` in every state value outside its printer's read set
   (the output on the write set bitwise the clean run's, every value
   outside the write set its input); K5
   in float64 on every call of one step at ``(8, 4, 16)``, at 1e-12 of
   the largest value (``Z4_F64_RTOL``), with the path's parameters and
   with those of the kernel's other branches (``Z4_PARAMS``), and the Z4
   step's three kernels the same way (the predictor's new state and faces,
   the face flux's F̂ and NCP halves, the update, the stage, a step), and
   in float32 at full width (the NCP halves, a cancelling difference,
   against the plain path in float64 as the viscous wall planes); the walled
   face stage launch by launch (its face fluxes, its side tensor of
   low-wall fluxes, the update), as a stage and in a step, in float64 in
   every mode and in float32 at full width; the viscous predictor (its new
   state, faces and wall planes) and the Navier–Stokes face stage the same
   way (the wall planes in float32 held to the scale of the face flux they
   are part of);
4. each main path: 10 steps (CK: the bench's window at its grid), with the
   launch counters, finiteness, mass drift (CK: materials bitwise frozen
   and the seismic energy ratio, also per half of the window), bitwise
   repeatability and the plain path as checks (the limited path also:
   admissibility, the rows demanded against the capacity, and one step's
   troubled mask against the plain path's, and the poison check: one step
   with NaN in every inactive slot of the gathered batch, its ghosts and
   its edge fluxes bitwise equal to the ordinary step; Z4: through
   ``CudaADERDG`` 3 launches a step over 10 steps, through
   ``with_cuda_rhs`` K5's (picard_iters + 2) over ``Z4_EAGER_STEPS``, both
   routes bitwise repeatable and against the plain path after
   ``Z4_EAGER_STEPS`` steps, with the error against the exact gauge wave and
   the ADM constraints of every path as readings);
5. times: step ms over 3 host-clock windows (the eager ``with_cuda_rhs``
   routes: one window of one step; the limited Z4+GRHD and viscous-shock
   paths: windows and profiled runs of ``TIME_STEPS``), DOF-updates/s, per-kernel (and
   for FV ``halo_fill`` / ``compute_dt``, for the limited step the rest of
   the step, for Z4 the eager stages) times with CUDA events, device idle
   share, peak memory, host synchronisations per limited step, the plain
   path beside them, and the seconds each path took; for each kernel of
   ``csrc/aderdg.cu`` a path launches, a ``[kernel]`` line with its
   registers and resident blocks per SM (the library's occupancy query) and
   its achieved TB/s and TFLOP/s beside its bound (the face stage's pair of
   launches also as one, against the stage's bound), the same for K3 (at
   the gathered batch's ``n_active`` and with every slot active, against
   the bound of the active rows) and for K4 with the bytes it moves (its
   read and write sets) beside those it needs;
6. a reading, not a check: the step at which ``bench.py``'s dt = 1e-4
   makes the ADER-DG state non-finite, on both paths.

It prints a JSON line of the kernels (with each one's bound, from this
run's shapes), the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
those lines; so does a machine without a CUDA card, and a directory that
holds this script without the package.  Imports no JAX.
"""

from __future__ import annotations

import copy
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parent

GRID = (256, 8, 128)   # bench.py:43
ORDER = 3
DX = 1.0 / GRID[0]     # bench.py:55
STEPS = 10
#: Steps a timing window and a profiled run take in the limited Z4+GRHD and
#: viscous-shock paths, whose eager steps last 0.13 and 0.43 s (their gates
#: run over ``STEPS``).
TIME_STEPS = 3
#: float32 kernel-vs-plain bound, in units of the float32 spacing (2⁻²³
#: relative) at the largest magnitude of the compared array.  The kernel
#: and the plain version are two float32 evaluation orders of the same
#: arithmetic, a few hundred dependent operations deep (Picard iterations,
#: contractions, Rusanov), with fused multiply-adds on one side only; each
#: is within ~1.4e-6 (~3 spacings at |u| ≈ 6) of the float64 step on this
#: state on a CPU.  64 spacings leaves a wide margin over that and stays
#: far below any real fault (a wrong coefficient moves values by ≥1e-3).
F32_ULPS = 64
SENTINEL = 1e30        # K4's sentinel outside its read set
F64_ATOL = 1e-12
#: Relative bound on the change of each conserved integral over the 10
#: steps.  The periodic flux form conserves them exactly; float32 rounding
#: of each update (≤ 2⁻²⁴ relative, 10 steps) bounds the drift by ~1e-6.
MASS_RTOL = 1e-5

#: The limited path (``bench.py:326-356``).
LIMITED_DT = 1.5e-4
CAPACITY = 128
DMP_DELTA0 = 5e-4
WARMUP = 5

#: The limited walls path: the limited path's step with reflective walls on
#: axis 0, from the bench's Sod state with a uniform flow u_x added (into
#: the high wall), so that the reflection troubles wall rows from the first
#: step; its float64 cut grid is the walls path's.
WALLS_UX = 0.5
WALLS_AXES = (0,)

#: The limited blast walls path (``examples/limited_blast_walls.py``): 2-D
#: p3 Euler in a reflective box, the whole-grid subcell fallback, the
#: pressurised disc r < 0.1 (ρ 1/0.125, p 10/0.1, at rest).  The example's
#: own grid at its dt = 2.5e-4 over its 20 steps, then (1024, 1024) (67.1 M
#: DOF, the scale of bench.py's 83.9 M) at the solver's cfl_dt of the
#: initial state over ``STEPS``; the float64 checks on (8, 8).
BLAST_GRIDS = ((16, 16), (1024, 1024))
BLAST_DT = 2.5e-4
BLAST_STEPS = 20
BLAST_CUT = (8, 8)
#: Flops of one 2-D Euler flux (the 3-D count less the third axis's kinetic
#: and advective terms: 1 division, pressure 7, coefficient 1, 3 advective
#: products, the pressure term 1, energy 3) and of one 2-D wave speed.
FLUX_OPS_2D = 16
EIG_OPS_2D = 15

#: The viscous shock path (``examples/viscous_shock.py``): 2-D p3
#: Navier–Stokes, periodic, the slab 0.25 < x < 0.75 at (ρ, p) = (1, 1),
#: (0.125, 0.1) outside, at rest, under ``LimitedADERDG(fallback_order=2)``
#: (the MUSCL whole-grid fallback, minmod) at half the viscous solver's
#: cfl_dt.  The example's chip grid (64, 4), dx = 1/64, in float64 over its
#: 120 steps for both viscosities with its gates (``:108-110``), then
#: (1024, 1024) (67.1 M DOF, the blast's scale) in float32, μ = 5e-3, over
#: ``STEPS``; the float64 kernel checks on ``BLAST_CUT``.
SHOCK_GRIDS = ((64, 4), (1024, 1024))
SHOCK_MU = 5e-3
SHOCK_STEPS = 120
SHOCK_PRANDTL = 0.7  # models/navier_stokes.py's default, the example's
#: The example's gates: conservation drift, the state difference the
#: viscosity makes.
SHOCK_DRIFT = 1e-12
SHOCK_DMAX = 1e-5
#: The 2-D vortex path (``examples/navier_stokes_vortex.py``): the periodic
#: Taylor–Green vortex, V0 = 1e-2, ρ = p = 1, μ = 5e-3, Pr = 0.7, at cfl_dt:
#: the example's (32, 32) over T = 0.25 in float64 with its gates (KE decay
#: rate within 2e-2 of 4ν(2π)², drift below 1e-11), and (1024, 1024) over
#: ``STEPS`` in float64 (in float32 a step moves the momenta by about one
#: float32 spacing there, so the decay cannot be read), the decay 1 − KE₁/KE₀
#: within ``VORTEX_RTOL`` of 1 − exp(−4ν(2π)²t) (on a CPU at (128, 128)
#: float64 the port's plain solver is 1.0e-5 from it after 10 steps).
VORTEX_GRIDS = ((32, 32), (1024, 1024))
VORTEX_MU = 5e-3
VORTEX_V0 = 1e-2
VORTEX_T = 0.25
VORTEX_RTOL = 2e-2
VORTEX_DRIFT = 1e-11
#: Flops of the 2-D viscous flux of both axes at one node, as
#: ``csrc/navier_stokes.cuh``'s 2-D form shares its terms (1/ρ 1, the
#: velocity 2, q² 3, T 4; per gradient axis ∂v 6, v·∂m 3, ∂T 8; ∇·v 1; per
#: flux axis τ 6, its 2 signs, the energy row 6) and its 6 sums into the
#: Euler flux (one node's 2-D gradients: :func:`visc_predictor_ops_2d`).
VISC_FLUX_OPS_2D = 1 + 2 + 3 + 4 + 2 * (6 + 3 + 8) + 1 + 2 * (6 + 2 + 6) + 6
#: The 2-D Navier–Stokes walls and order-2 phase (``ns2d_walls_path``): the
#: solvers of the JAX package's viscous-wall tests (``tests/
#: test_navier_stokes.py:387-503``) and Pallas Navier–Stokes tests (``:237-268``,
#: ``tests/test_parallel.py:888-928``).  Kernel against plain on
#: ``NS2W_CUT`` (dx_1 = 0.7/g1: unequal axes), a ragged last predictor block
#: at both orders, in every wall mode at order 3 and order 2 and periodic at
#: order 2, float64 at ``F64_ATOL`` and float32 (64 spacings of the largest
#: plain value; the wall planes against the plain float64 planes, as the 3-D
#: viscous path holds them).
NS2W_CUT = (5, 7)
NS2W_MU = 0.02
NS2W_MODES = ("noslip_box", "noslip_1", "outflow_0", "farfield_0", "dirichlet")
NS2W_F32_MODES = ("periodic", "noslip_box")
NS2W_MASS_RTOL = 1e-12
#: The JAX tests' anchors on the kernels in float64: the no-slip channel
#: (order 3, μ = 0.01, walls on axis 0, v_y = 1e-3 sin πx) decays at ν π²
#: within 2e-2 over t ≈ 1 at the JAX test's (8, 8) and at (16, 16); the
#: closed order-2 box (μ = 0.05, the Taylor–Green velocity of 1e-3) keeps its
#: mass to 1e-12 over 160 steps at cfl_dt and its kinetic energy falls below
#: 0.8 of its start; outflow walls on axis 0 (order 3, μ = 5e-3, (16, 8), the
#: density bump) give the periodic answer to 1e-12 over 3 steps of 5e-4.
NS2W_CHANNEL_GRIDS = ((8, 8), (16, 16))
NS2W_CHANNEL_MU = 0.01
NS2W_RATE_RTOL = 2e-2
NS2W_BOX_STEPS = 160
NS2W_BOX_KE = 0.8
NS2W_OUTFLOW_GRID = (16, 8)
#: The timed runs, float32 at the viscous-shock phase's (1024, 1024):
#: (label, order, wall mode, state), each ``TIME_STEPS`` steps at cfl_dt on
#: the main path, then 3 windows of ``TIME_STEPS``; the runs of the kernel
#: lines (the p3 no-slip channel, the p2 periodic solver and box) also hold
#: their kernels against plain in float32 on the timed state.
NS2W_GRID = (1024, 1024)
NS2W_RUNS = (
    ("p3 periodic", 3, "periodic", "vortex"),
    ("p3 no-slip channel", 3, "noslip_0", "channel"),
    ("p3 outflow", 3, "outflow_0", "bump"),
    ("p3 no-slip box", 3, "noslip_box", "box"),
    ("p2 periodic", 2, "periodic", "smooth"),
    ("p2 no-slip box", 2, "noslip_box", "box"),
)

#: The FV path (``__graft_entry__.py:16-36``): 3-D Euler, patch 4, halo 1.
FV_WIDTH = dict(dim=3, patch_size=4, halo_size=1, n_real=5, n_aux=0)
FV_GRIDS = ((8, 8, 128), (32, 16, 128))
FV_CFL = 0.45

#: The order-generic 3-D Euler path (K1 c: the space-time predictor of
#: ``csrc/aderdg_st.cuh`` and the face stage at n = 5, 6, 8, periodic and
#: walled), orders 4, 5 and 7, keyed by order.  Order 5 is
#: ``examples/high_order_p5.py``'s step: 3-D compressible Euler (6 Picard
#: iterations), periodic, dx = 1/g0, dt = 2e-5 (``:77``), the exact density
#: wave of ``:61-76`` (γ = 1.4, p0 = 2, velocity (1, 0.5, 0.25)) at the
#: example's chip grid and at 4x its cells (the DOF scale of ``bench.py``'s
#: p3 grid), 10 steps.  The example's wave sin(2π(x + y + z)) has a unit
#: period along every axis, and axis 1 of both grids is 0.125 long: there it
#: is not periodic, and its seam, not the scheme, sets the error (0.0202 at
#: (32, 4, 32) after the 10 steps on the plain path, which equals JAX's to
#: 1e-12).  So the gated wave takes, along an axis shorter than the unit,
#: the shortest wave that is periodic on it (one period over its extent:
#: sin(2π(x + 8y + z)) on both grids), still an exact solution (a density
#: profile carried by a uniform flow at uniform pressure); the example's
#: wave as written is run too, as a reading.  Orders 4 and 7 run the same
#: wave at ``cfl_dt`` (``None`` in ``ST_DT``; its factor min(0.4,
#: 1.5/(N+2)) holds in both packages, ``tests/test_torch_aderdg_orders.py``)
#: at about the main path's DOF count (81.9 M and 83.9 M), order 7 also at
#: ``scripts/mxu_probe.py:73``'s ``(16, 4, 32)``.  The first grid of each
#: order carries its kernel JSON lines and its walls: a reflective box
#: (mass and energy within ``MASS_RTOL``, momentum moved), an outflow
#: channel on axis 0 and the farfield state's uniform flow in a farfield
#: channel on axis 0 (steady), each 10 steps; every wall mode against the
#: plain path in float64 on the cut grid.  The plain path runs
#: ``ST_PLAIN_STEPS`` steps for the comparison, one window for its time.
ST_ORDERS = (4, 5, 7)
ST_GRIDS = {4: ((128, 8, 128),), 5: ((32, 4, 128), (64, 8, 128)),
            7: ((32, 8, 128), (16, 4, 32))}
ST_CUTS = {4: (4, 2, 8), 5: (4, 2, 8), 7: (2, 2, 4)}
ST_DT = {4: None, 5: 2e-5, 7: None}
WAVE_GAMMA, WAVE_P0, WAVE_VEL = 1.4, 2.0, (1.0, 0.5, 0.25)
#: The example's gates (``examples/high_order_p5.py:97-99``: the error
#: against the exact wave, the absolute drift of the mass), at every order.
ST_ERR_GATE = 5e-3
ST_MASS_GATE = 1e-5
ST_PLAIN_STEPS = 2
ST_WALLS = ("reflective box", "outflow (0,)", "farfield (0,)", "dirichlet box",
            "reflective (1, 2)")
#: f64 kernel-vs-plain bound, relative to max(1, max|plain|).
ST_F64_RTOL = 1e-12
#: The order anchor: the exact wave on ``ST_ANCHOR_GRID`` (dx = 1/4, periodic
#: on every axis) to t = ``ST_ANCHOR_T`` in ``ST_ANCHOR_STEPS`` steps, float64,
#: through the kernels of each order (3 through ``csrc/aderdg.cu``'s order-3
#: instances): the error against the exact wave must fall from order to
#: order, or be under ``ST_ANCHOR_FLOOR``.
ST_ANCHOR_ORDERS = (3, 4, 5, 7)
ST_ANCHOR_GRID = (4, 4, 4)
ST_ANCHOR_T = 0.05
ST_ANCHOR_STEPS = 80
ST_ANCHOR_FLOOR = 1e-10

#: The CK path (``bench.py:151-294``).
CK_GRIDS = ((64, 4, 32), (256, 8, 128))
CK_DT = 2e-4           # bench.py:204, at the bench's grid
CK_WARMUP = 5          # the bench's first chunk
CK_WINDOW = 40         # its 8 chunks of 5 steps
CK_ENERGY_GATE = 1.02  # bench.py:280
CK_EVOLVED = 9

#: The layered seismic path (``examples/seismic3d_layered.py``): the
#: example's CPU grid in float64 (the kernel checks and its run) and its
#: chip grid in float32 (``:44``), each to the time the example's 80 and 400
#: steps reach (``:86``, ``:114``), then on past the kinematic P arrival at
#: the nearest receiver (t_expect ≈ 0.127 and 0.120), where the example's
#: arrival gate applies.  The sponge (``:64``), the Ricker force (``:103``)
#: and the layers (``:47-49``) are the example's; its dt is not.  The
#: example steps at ``cfl_dt`` with the solver's default cfl, min(0.4,
#: 1.5/(N + 2)) = 0.3, and at that dt this CK step grows without bound in
#: both packages (``tests/test_torch_seismic3d.py::
#: test_seismic_example_dt_diverges_in_both_packages``: JAX's own XLA step
#: and the port's past 1e9 after 120 steps on the CPU grid, where the
#: physical field is O(100)), as does every 3-D order-3 elastic step there
#: (``tests/test_torch_ck_cfl.py``: periodic or walled, homogeneous or
#: layered, CK or Picard); at half that dt it stays bounded.  So the path
#: steps at ``cfl_dt(u0, cfl=SEIS_CFL)`` over twice the example's step
#: counts.
SEIS_GRIDS = ((9, 9, 6), (63, 63, 36))
SEIS_CFL = 0.15
SEIS_STEPS = (160, 800)
SEIS_ARRIVAL_STEPS = (240, 1600)
SEIS_SPONGE = dict(width=0.12, rate=40.0, axes=(0, 1), n_wave=9)
SEIS_F0 = 8.0
SEIS_UP, SEIS_LO = (1.0, 2.0, 1.0), (1.2, 9.6, 4.8)  # ρ, λ, μ above and below half depth
SEIS_SYM = 1e-5       # :146, of the seismogram's largest value
SEIS_ARRIVAL = 0.5    # :154, of t_expect
#: Seeded noise on the 9 wave rows of the kernel checks (the example starts
#: from rest, and by step 800 its field has not reached the sponge), the
#: forced steps the float64 kernel path is held to the plain path over, and
#: the float32 ones at full width.
SEIS_NOISE = 1e-3
SEIS_F64_STEPS = 5
SEIS_PLAIN_STEPS = 10
#: f64 kernel-vs-plain bound, relative to max(1, max|plain|).
SEIS_F64_RTOL = 1e-12

#: K2 b, the homogeneous elasticity on the CK kernels.  3-D: ``elastic3d``
#: (ρ, λ, μ = 1, 2, 1) at order 2, periodic, at CK's 3-D grid (63.7 M DOF,
#: 255 MB in float32), dt = ``cfl_dt`` at cfl 0.15 (the default cfl, 0.375
#: at order 2, and 0.3 grow a seeded plane wave without bound here as at
#: order 3: ``EL3_CFL_STEPS`` steps of each are a reading), float64 parity at two cut
#: grids (one ragged in every tiling), 10 steps of the plane P wave against
#: the plain path and the exact wave (``EL3_EXACT`` of its max).
EL3_GRID = (256, 8, 128)
EL3_CUTS = ((4, 4, 8), (3, 5, 7))
EL3_ORDER = 2
EL3_MATERIALS = (1.0, 2.0, 1.0)
EL3_CFL = 0.15
EL3_STEPS = 10
EL3_EXACT = 1e-3
EL3_CFL_STEPS = 300
EL3_SEED = 1e-3  # of EL_NOISE: the growth reading's seed
#: 2-D: ``examples/seismic_point_source.py --ck`` (ρ, λ, μ = 1, 2, 1, a
#: vertical Ricker force of f0 = 8 at (0.5, 0.5), receivers at x = 0.3, 0.4,
#: 0.6, 0.7 and y = 0.3, dt = ``cfl_dt`` of a state of ones) on the odd grid
#: ``EL2_GRID`` for ``EL2_STEPS`` steps, t ≈ 0.2 past the kinematic P
#: arrival t_expect ≈ 0.156 (the example's own (128, 128) grid puts the
#: source on a cell face, and its 400 steps end at t ≈ 0.067: a reading,
#: ``EL2_EXAMPLE``), with its gates (``:79-100``: mirror symmetry below
#: ``EL2_SYM`` of the field's maximum, the arrival within ``EL2_ARRIVAL`` of
#: t_expect); float64 parity at two cut grids, periodic and with the free
#: surface; the forced step timed at ``EL2_TIME_GRID`` (16.8 M DOF) after
#: ``EL2_TIME_WARMUP`` steps, and the kernels against plain there on that
#: field with seeded noise.
EL2_MATERIALS = (1.0, 2.0, 1.0)
EL2_F0 = 8.0
EL2_GRID = (129, 129)
EL2_STEPS = 1200
EL2_EXAMPLE = ((128, 128), 400)
EL2_CUTS = ((9, 9), (5, 7))
EL2_TIME_GRID = (1024, 1024)
EL2_TIME_WARMUP = 50
EL2_PLAIN_STEPS = 10
EL2_REPEAT_STEPS = 300  # the run's first steps, run twice: bitwise equal
EL2_SYM = 1e-5
EL2_ARRIVAL = 0.5
#: Seeded noise of the K2 b kernel checks.
EL_NOISE = 1e-3
#: K2 b.1, frozen slots and the dissipation mask on the CK node kernel.
#: ``examples/seismic_topography.py``'s configuration: the 2-D elasticity
#: (ρ, λ, μ = 1, 2, 1) lifted onto the hill mapping of height 0.04
#: (``:49-58``), order 3, periodic, the example's chip grid (96, 96) in
#: float32, its vertical Ricker force (f0 = 8 at (0.5, 0.35)) and four
#: receivers at y = 0.6 sampled after each forced step, dt 1e-4; run for
#: ``TOPO_STEPS`` steps to t = 0.3, past the kinematic P arrival at every
#: receiver (c_p = 2: the Ricker's centre, 1/f0 = 0.125, reaches the nearest
#: at t ≈ 0.26; the seismograms' maxima come at t ≈ 0.245-0.275).  The example's own 400 steps end at t = 0.04, before the
#: wavelet has left the source: a reading (``TOPO_EXAMPLE_STEPS``).  Its
#: gates (``:140-164``): the flat limit (height 0) against the Cartesian 2-D
#: CK step (K2 b's ``elastic`` instance) within ``TOPO_FLAT`` of the field
#: maximum, the metric slots frozen, the hill moving the seismogram by more
#: than ``TOPO_EFFECT`` of it; here also the seismogram's maximum at each
#: receiver after the P travel time r/c_p plus half the wavelet's period.
TOPO_MATERIALS = (1.0, 2.0, 1.0)
TOPO_HEIGHT = 0.04
TOPO_GRID = (96, 96)
TOPO_DT = 1e-4
TOPO_STEPS = 3000
TOPO_EXAMPLE_STEPS = 400
TOPO_SOURCE = (0.5, 0.35)
TOPO_RX = (0.3, 0.4, 0.6, 0.7)
TOPO_RX_Y = 0.6
TOPO_F0 = 8.0
TOPO_FLAT = 1e-5
TOPO_EFFECT = 1e-3
TOPO_PLAIN_STEPS = 10
TOPO_REPEAT_STEPS = 200  # the hill run's first steps, run twice: bitwise equal
#: Float64 parity grids of the 2-D systems (one ragged in both tilings) and
#: of the 3-D one; the forced curvilinear step and the 2-D heterogeneous
#: step timed at ``K2B1_TIME_GRID`` (16.8 M nodes, 10 and 8 variables).
K2B1_CUTS = ((9, 9), (5, 7))
K2B1_TIME_GRID = (1024, 1024)
K2B1_TIME_WARMUP = 20
#: The 12-variable heterogeneous elasticity at order 2 (``tests/test_ck.py:
#: 317``'s system) at CK's 3-D grid (84.9 M values), the two-layer
#: materials and the plane P wave of ``two_layer_state``, dt = ``cfl_dt`` at
#: cfl 0.15 (ROADMAP Queue 3: the default diverges in 3-D).
HET3_GRID = (256, 8, 128)
HET3_CUTS = ((4, 4, 8), (3, 5, 7))
HET3_CFL = 0.15
HET3_STEPS = 10
#: ``tests/test_ck.py:139``'s constant materials: the 2-D heterogeneous
#: step's wave rows against K2 b's homogeneous ``elastic`` instance.
HET2_MATERIALS = (1.2, 2.1, 0.9)
HET2_STEPS = 5
#: Flops of one flux along an axis (``csrc/elastic.cuh``): the curvilinear
#: lift, 5 divisions by J, two ``Elastic2D`` fluxes of 5 and the 5 rows'
#: J·a^k_0 F_0 + J·a^k_1 F_1 (3 each); the 2-D heterogeneous one, 2 products
#: by 1/ρ, λ + 2μ (2), and 3 products (1/ρ once a node, counted by
#: ``ck_predictor_ops``).  The curvilinear wave speed: 2 divisions, the norm
#: (3), the root and the product by c_p; the heterogeneous one is
#: ``ELASTIC_EIG_OPS``.
CURV_FLUX_OPS = 5 + 2 * 5 + 3 * 5
HET2_FLUX_OPS = 7
CURV_EIG_OPS = 7
#: State rows the curvilinear face flux along axis k needs a side: the 5
#: wave rows, J, J·a^k_0 and J·a^k_1.
CURV_READ = 5 + 1 + 2
#: Flops of one homogeneous elastic flux (``csrc/elastic.cuh``): 3-D, 3
#: divisions, 5 for the normal stress, 2 for the other normal stresses, 7
#: for the two shear rows with the normal (their 0·v_x products and + 0
#: terms) and 1 for the third; 2-D, 2 divisions and 3 products.  The wave
#: speed is a constant (0 flops).
EL3_FLUX_OPS = 18
EL2_FLUX_OPS = 5

#: The walls path: the float64 cut grid (axis 2 is not a multiple of the
#: face stage's 32-cell tile, so its ragged tile meets the walls), the
#: farfield state of tests/test_aderdg.py:404 in 3-D (a uniform flow along
#: axis 0 at Mach 1.69), and the CK free surface's wall axis (the layered
#: seismic box's, examples/seismic3d_layered.py:58).
WALL_CUT = (8, 4, 8)
FARFIELD = (1.0, 2.0, 0.0, 0.0, 1.0 / 0.4 + 0.5 * 2.0**2)
FREE_SURFACE_AXES = (2,)

#: The viscous path: 3-D compressible Navier–Stokes at order 3.  The float64
#: parity cases take tests/test_navier_stokes.py's μ = 0.02, Pr = 0.7 on a
#: cut grid (dx = 1/8); the full-width state is the Taylor–Green vortex of
#: the 1st International Workshop on High-Order CFD Methods as DeBonis
#: (NASA TM-2013-217850) sets it, on the unit box: V0 = 1, ρ0 = 1, Mach 0.1
#: (p0 = 1/(γ·0.01)), Re = 1600 with L = 1/(2π), so μ = 1/(2π·1600), and
#: Pr = 0.71.
NS_GRID = (64, 64, 64)
NS_CUT = (8, 4, 8)
NS_MU, NS_PRANDTL = 0.02, 0.7
TGV_MACH, TGV_RE, TGV_PRANDTL = 0.1, 1600.0, 0.71
TGV_L = 1.0 / (2.0 * math.pi)
TGV_MU = TGV_L / TGV_RE            # ρ0 V0 L / Re
TGV_P0 = 1.0 / (1.4 * TGV_MACH**2)  # ρ0 V0² / (γ M²)
NS_WALL_AXES = (0,)                 # the no-slip walls of the walled vortex
#: The decay anchors (tests/test_navier_stokes.py:149-189 and :405-435 in
#: 3-D, float64): a shear mode v_z = V sin(2πx) on a periodic (16, 4, 4)
#: grid decays at ν(2π)², the no-slip channel mode v_y = V sin(πx) at νπ².
NS_ANCHOR_RTOL = 2e-2
#: The periodic vortex's kinetic energy over its 10 steps falls by
#: 1 − exp(−2ν|k|²t), |k|² = 3/L² (the initial rate of a single-wavenumber
#: divergence-free field; ρ0 = 1, so ν = μ), within the anchors' 2e-2.
TGV_K2 = 3.0 / TGV_L**2
#: The float32 wall planes of the viscous split (the viscous-only wall flux,
#: a small difference of large terms at Mach 0.1) are held against the
#: plain predictor in float64, to this many times the plain float32 path's
#: own distance from it.
FVWALL_F32_FACTOR = 4

#: The Z4 path (``scripts/z4_probe.py --large --pallas``: ``:53-57, 81-82,
#: 198-202, 225-229``): the 38-variable vacuum Z4 system, order 2, 3-D,
#: harmonic slicing f = 1, m = 2, κ₁ = κ₂ = 0, the gauge wave of amplitude
#: 0.1 along axis 0, dt = 1e-4.
Z4_GRID = (16, 16, 128)
Z4_DX = 1.0 / 128
Z4_ORDER = 2
Z4_DT = 1e-4
Z4_AMPLITUDE = 0.1
#: The f64 kernel-vs-plain grid (same dx and amplitude).
Z4_CUT = (8, 4, 16)
#: The parameters of K5's f64 checks: the kernel's other branches, 1+log
#: slicing (g = 2/α, d(αg)/dα = 0) and harmonic slicing with f ≠ 1, each
#: with m ≠ 2 and both κ damping terms (the path's own parameters are held
#: in float32 at full width).
Z4_PARAMS = (
    dict(slicing="1+log", f=0.7, m=1.5, kappa1=0.1, kappa2=0.3),
    dict(f=0.7, m=1.5, kappa1=0.1, kappa2=0.3),
)
#: f64 K5 bound, relative to max(1, max|plain|): the right-hand side reaches
#: ~580 on the cut grid (its wavelength is 8 cells), so an absolute 1e-12 is
#: too tight for two evaluation orders of a ~3,900-operation algebra (fused
#: multiply-adds on the card's side only); they differ by a few float64
#: spacings of the largest intermediate, far below 1e-12 of it.
Z4_F64_RTOL = 1e-12
#: The shifted Z4 path (``scripts/z4_probe.py --shift --large``, ``:166-171,
#: 189-196``, on the solver of ``:53-57``): the 53-variable system, order 2,
#: 3-D, the Gamma-driver (f_b = 0.75, η = 1; harmonic slicing f = 1, m = 2,
#: κ₁ = κ₂ = 0) on the fused right-hand side (``fused_rhs="soa"``), the
#: moving gauge wave (v = 0.2, amplitude 0.1) on ``Z4_GRID``, dt = 1e-4.
Z4S_PARAMS = dict(shift="gamma_driver", f_b=0.75, eta=1.0)
Z4S_V = 0.2
#: The f64 kernel-vs-plain family at ``Z4_CUT``: the Gamma-driver with
#: 1+log slicing, f_b ≠ 0.75 and m ≠ 2 (``tests/test_z4.py:936-940``; the
#: frozen shift and the κ₁-damped driver are the card tests', and the path's
#: own parameters are held in float32 at full width).
Z4S_FAMILIES = (
    dict(shift="gamma_driver", slicing="1+log", f_b=0.5, m=1.5),
)
#: Seeded noise on every slot of the states that hold the shifted kernels
#: against their plain versions: on the exact moving wave b = B = 0 and
#: ∂b = ∂B = 0, so a kernel that dropped those terms would pass there.
Z4S_NOISE = 1e-4
#: The Z4+GRHD path (``scripts/z4_probe.py --matter --large --pallas``,
#: ``:77-196``, fused as ``:174-196`` runs it): the 43-variable coupled system,
#: order 2, 3-D, geodesic slicing (harmonic, f = 0), Γ = 5/3, 10 Newton trips,
#: on ``Z4_GRID`` at dx = 1/128, from ``examples/flrw_cosmology.py``'s FLRW slice
#: (ρ₀ = 0.02, ε₀ = 0.4, a = 1, ȧ from the Hamiltonian constraint) with the
#: probe's perturbation: slots 38 and 42 (D̃, τ̃) times 1 + 0.05 sin(2π i₂/g₂)
#: along grid axis 2; dt = 1e-4; ``Z4M_WARMUP`` steps, then ``STEPS`` checked.
Z4M_PARAMS = dict(slicing="harmonic", f=0.0)
Z4M_RHO0 = 0.02
Z4M_EPS0 = 0.4
Z4M_PERT = 0.05
Z4M_WARMUP = 5
#: The f64 kernel-vs-plain family at ``Z4_CUT``: the kernels' other
#: branches (1+log slicing, m ≠ 2, κ damping, Γ = 4/3, 7 Newton trips; the
#: path's own parameters are held in float32 at full width).
Z4M_FAMILIES = (
    dict(slicing="1+log", m=1.5, kappa1=0.1, kappa2=0.3, gamma=4.0 / 3.0, iters=7),
)
#: The parity states: ``pack_matter`` of the FLRW metric with seeded noise
#: of this size on every Z4 slot, ρ ≈ 0.02, p ≈ 0.008 and a velocity field
#: of up to 0.15 a component (on the FLRW state v = 0, so the flux's
#: velocity terms and the momentum sources would vanish).
Z4M_NOISE = 1e-3
#: Gates of the matter path: D̃ conserved to this relative drift over the
#: checked steps (periodic, a conservative flux, no D̃ source: float32
#: rounding only); on the exact homogeneous FLRW universe after 10 steps (t
#: = 1e-3) a² = γ_xx within ``Z4M_A2_RTOL`` of the Friedmann reference's (in
#: float32, a² ≈ 1.001 carries 1.2e-7 spacings; the ADER-DG truncation at dt
#: = 1e-4 is far smaller), D̃ within ``Z4M_DRIFT`` of ρ₀ (a³ρ = ρ₀ exactly)
#: and |Θ|, |Z| (zero on the exact slice) under ``Z4M_CONSTRAINT``.
Z4M_DRIFT = 1e-5
Z4M_A2_RTOL = 1e-5
Z4M_CONSTRAINT = 1e-6
#: Flops of the hydro flux of the three axes at a point beside the recovery
#: it shares with the algebra (``csrc/z4_matter.cuh::flux``): √γ p, and per
#: axis α D̃ v^d 2, the momentum rows 6 and the pressure term 2, α (τ̃ + √γ
#: p) v^d 3.
Z4M_FLUX_OPS = 1 + 3 * (2 + 6 + 2 + 3)
#: The limited Z4+GRHD path (ROADMAP Queue 1 item 9.4; the limiter over the
#: coupled system of ``tests/test_z4_matter.py:503-543``, ExaGRyPE's shape of
#: a shock-capturing fluid on a dynamic spacetime): the Z4+GRHD path's solver
#: and FLRW slice (``Z4M_*``, without the sine), D̃ and τ̃ times 1 +
#: ``Z4L_AMP``·exp(−|x − c|²/``Z4L_WIDTH``) at the box centre c, w = 2 dx²
#: (σ = one cell: the JAX test's bump is as sharp against its cells, and a p2
#: cell cannot resolve it, so the detector fires); capacity 128 rows (the
#: limited Euler path's ``CAPACITY``, half of the 256 rows); dt = ``Z4_DT``,
#: ``Z4M_WARMUP`` warm-up steps, then ``STEPS`` checked.
Z4L_AMP = 4.0
Z4L_WIDTH = 2.0 * Z4_DX**2
#: The Z4+GRMHD path (Queue 1 item 7.3: the ExaGRyPE flagship shape of
#: ``exahype_tpu/models/z4_grmhd.py``, fused as ``__graft_entry__.py:559-600``
#: steps it): the 47-variable coupled system, order 2, 3-D, geodesic slicing
#: (harmonic, f = 0), Γ = 5/3, the recovery's 20 Newton trips (the JAX
#: default), c_h = 1, GLM damping κ = 0.5, on ``Z4_GRID`` at dx = 1/128, from
#: the magnetized wave of ``tests/test_z4_grmhd.py:460-486`` (γ_xx = 1 +
#: 0.05 sin kx, ρ = 1 + 0.1 sin, p = 1 + 0.05 cos, v_y = 0.1 sin, B^x = 0.05,
#: B^z = 0.015 cos) with one period along grid axis 0; dt = 1e-4;
#: ``Z4G_WARMUP`` steps, then ``STEPS`` checked.
Z4G_PARAMS = dict(slicing="harmonic", f=0.0, gamma=5.0 / 3.0, iters=20, c_h=1.0,
                  glm_kappa=0.5)
Z4G_B0 = 0.05
Z4G_AMP = 0.05
Z4G_WARMUP = 5
#: The f64 kernel-vs-plain family at ``Z4_CUT``: the kernels' other
#: branches (f = 1, κ₁ damping, a cleaning speed under the cone, strong GLM
#: damping; the path's own parameters are held in float32 at full width).
Z4G_FAMILIES = (
    dict(Z4G_PARAMS, f=1.0, kappa1=0.1, c_h=0.8, glm_kappa=2.0),
)
#: The parity states: ``pack_matter_mhd`` of flat space with seeded noise of
#: this size on every Z4 slot, ρ ≈ 1, p ≈ 1, a velocity field of up to 0.15
#: a component, a field of 0.05 to 0.1 a component (nowhere zero: in float32
#: a zero field recovers NaN in the reference, ``ROADMAP.md`` Queue 3) and a
#: GLM scalar of ~1e-2.
Z4G_NOISE = 1e-3
#: Gates: ∫D̃ dV within ``Z4G_DRIFT`` of itself and each ∫B̃^i dV within it
#: of ∫|B̃| dV over the checked steps (a conservative flux, no source:
#: float32 rounding only; the JAX test's bar is 1e-10 in float64); the
#: zero-field cross-check at the JAX bar of
#: ``tests/test_z4_grmhd.py::test_zero_field_reduces_to_coupled_hydro``
#: (rtol, atol): the two systems recover through different Newtons, z
#: against p, and agree to the recovery's convergence.  Its cleaning speed
#: is under the cone, so the Rusanov speeds of the two systems are alike.
Z4G_DRIFT = 1e-5
#: Steps of the Z4 paths' eager routes at full width (``with_cuda_rhs`` and
#: the plain path: 0.4 s to ≳1 s a step, most of it PyTorch calls; the
#: Z4+GRMHD flux's vector Newton is the slowest); the kernel path is held to
#: the plain path after these, and runs its own ``STEPS``.
Z4_EAGER_STEPS = 1
Z4G_ZERO_FIELD_TOL = (1e-7, 1e-9)
Z4G_ZERO_FIELD_CH = 0.5
#: Flops of the matter flux of the three axes at a point beside the recovery
#: it shares with the algebra (``csrc/z4_grmhd.cuh::flux``): per axis √γ p*
#: 1; α D̃ v^d 2; α ((τ̃ + √γ p*) v^d − √γ (v·B) B^d) 6; α c_h² B̃^d 3; the
#: momentum rows α √γ B^d and W² 3, 7 each and the pressure term 2; the
#: induction rows 4 each and the φ̃ term 2.
Z4G_FLUX_OPS = 3 * (1 + 2 + 6 + 3 + (3 + 3 * 7 + 2) + (3 * 4 + 2))
#: The Rusanov bound's operations (``csrc/z4_grmhd.cuh::wave_speed``): the
#: vacuum cone's 23 and the max with c_h.
Z4G_EIG_OPS = 24
#: The vacuum Z4 system on K1 d's per-axis branch and 2-D kernels: the JAX
#: package's default build (``make_z4_solver(..., fused_rhs=False)``, the
#: per-axis NCP) and its 2-D forms at orders 2 (``tests/test_z4.py:497-529``,
#: the dryrun's ``__graft_entry__.py:483-503``) and 3
#: (``examples/z4_gauge_wave.py:43-51``), per-axis and fused, at
#: ``Z4F_GRID`` (22.4 M and 39.8 M DOF, the order of the 3-D cell's 33.6
#: M), dx = 1/256, and the 3-D per-axis step on ``Z4_GRID``: the gauge wave
#: of amplitude 0.1 with seeded noise of ``Z4F_NOISE`` on every slot (the
#: exact wave's zero slots would hide a dropped term), dt = 1e-4.
Z4F_FORMS = ((2, 2, False), (2, 2, "soa"), (2, 3, False), (2, 3, "soa"), (3, 2, False))
Z4F_GRID = (256, 256)
Z4F_CUT = (8, 6)  # f64 parity (MC_Z4_CUT), dx = 1/64; the 3-D form's Z4_CUT
Z4F_CUT_DX = 1.0 / 64
Z4F_NOISE = 1e-3
Z4F_STEPS = 5
#: The example on its chip grid and in its CPU configuration
#: (``examples/z4_gauge_wave.py:40-76``): order 3, per-axis, harmonic f = 1,
#: amplitude 0.01, (cells, 2) at dx = 1/cells, 4 cells steps to t = 0.1; its
#: gates (error against the exact wave, largest ADM constraint) by grid: the
#: chip's at 64 cells, the CPU's at 8.  In float32 its chip run fails them
#: in both packages (ROADMAP.md Queue 3: a mode seeded by float32 rounding
#: grows ~8 % a step, the constraint from ~1e-5 at step 32 to ~20 at 256),
#: so the chip grid is gated in float64 and its float32 run is a reading.
Z4X_CASES = ((64, "float32"), (64, "float64"), (8, "float64"))
Z4X_GATES = {64: (5e-4, 1e-3), 8: (5e-5, 1e-10)}
Z4X_T = 0.1
Z4X_AMPLITUDE = 0.01
#: Steps of the plain path beside the kernels on the example's grids.
Z4X_PLAIN_STEPS = 1
#: The Z4+GRHD system on K1 d's per-axis branch with its flux and on the 2-D
#: kernels: the JAX package's default build (``make_z4_matter_solver(...,
#: fused_rhs=False)``, ``exahype_tpu/models/z4_matter.py:305-357``) in 3-D
#: and 2-D, and its fused 2-D step, at order 2, in the matter path's gauge
#: (``Z4M_PARAMS``: geodesic slicing, Γ = 5/3, 10 Newton trips); the 3-D
#: per-axis step on ``Z4_GRID`` at dx = 1/128, the 2-D steps on ``Z4F_GRID``
#: at dx = 1/256; held to the plain stages on ``z4m_noisy`` states (f64 on
#: ``Z4_CUT`` and ``Z4F_CUT`` in ``Z4M_FAMILIES``, f32 at full width),
#: run and timed from the perturbed FLRW slice (``z4m_flrw``, the sine along
#: the last grid axis), dt = ``Z4_DT``, ``Z4F_STEPS`` steps a form.
Z4MF_FORMS = ((3, False), (2, False), (2, "soa"))
#: ``examples/flrw_cosmology.py`` (``:36-50, 66-68``): 2-D, order 2,
#: per-axis, geodesic slicing, Γ = 5/3, the homogeneous FLRW universe (ρ₀ =
#: 0.02, ε₀ = 0.4, a = 1) at dx = 0.25, 100 steps to t = 0.5, on its own (4,
#: 4) cells and on the chip grid (256, 256) (the same dx and dt, so the
#: homogeneous universe keeps its CFL); its bars (a² = γ_xx against the
#: Friedmann reference, D̃ against ρ₀, |Θ|, |Z|), gated in float64, read in
#: float32.
Z4MX_GRIDS = ((4, 4), (256, 256))
Z4MX_DX = 0.25
Z4MX_T = 0.5
Z4MX_STEPS = 100
Z4MX_BARS = dict(a2=1e-7, Dt=1e-9, theta=1e-9, Z=1e-9)
#: The Z4+GRMHD system on K1 d's per-axis branch with its flux and on the
#: 2-D kernels: the JAX package's default build (``make_z4_grmhd_solver(...,
#: fused_rhs=False)``, ``exahype_tpu/models/z4_grmhd.py:361-415``, the solver
#: of every Z4+GRMHD test there, ``tests/test_z4_grmhd.py:493-639``, and of
#: the dryrun's GSPMD check) in 3-D and 2-D, and its fused 2-D step, at
#: order 2, in the Z4+GRMHD path's gauge and cleaning (``Z4G_PARAMS``); the
#: 3-D per-axis step on ``Z4_GRID`` at dx = 1/128, the 2-D steps on
#: ``Z4F_GRID`` at dx = 1/256; held to the plain stages on ``z4g_noisy``
#: states (f64 on ``Z4_CUT`` and ``Z4F_CUT`` in ``Z4G_FAMILIES``, f32 at full
#: width), run and timed from the magnetized wave (one period along grid
#: axis 0, a field nowhere zero), dt = ``Z4_DT``, ``Z4F_STEPS`` steps a form,
#: gated as the Z4+GRMHD path (finite, admissible, ``Z4G_DRIFT``); the
#: zero-field cross-check of each form in f64 on the cut grids.
Z4GF_FORMS = ((3, False), (2, False), (2, "soa"))
#: The shifted system on K1 d's per-axis branch and on the 2-D kernels: the
#: JAX package's default build (``make_z4_shift_solver(...,
#: fused_rhs=False)``, ``exahype_tpu/models/z4.py:511-563``, the solver of
#: every shifted test there, ``tests/test_z4.py:802-897``, and of
#: ``scripts/z4_probe.py --shift --large``'s per-axis runs, ``:76-82,
#: 166-171``) in 3-D and 2-D, and its fused 2-D step, at order 2, in the
#: shifted path's gauge (``Z4S_PARAMS``: the Gamma-driver, f_b = 0.75, η = 1);
#: the 3-D per-axis step on ``Z4_GRID`` at dx = 1/128, the 2-D steps on
#: ``Z4F_GRID`` at dx = 1/256; held to the plain stages on the moving gauge
#: wave (v = ``Z4S_V``, amplitude 0.1) with ``Z4S_NOISE`` on every slot (f64
#: on ``Z4_CUT`` and ``Z4F_CUT`` in ``Z4S_FAMILIES``, f32 at full width; the
#: frozen shift is the anchors' and the card tests'), run and timed from the
#: noisy wave, dt = ``Z4_DT``, ``Z4F_STEPS`` steps a form.
Z4SF_FORMS = ((3, False), (2, False), (2, "soa"))
#: The JAX package's shifted anchors, in float64 through the 2-D per-axis
#: kernels on their own grids (``tests/test_z4.py:802-860``): Minkowski with
#: the constant shift ``Z4SX_BETA`` on (4, 2) cells at dx = 0.25 stationary
#: to ``Z4SX_STATIONARY`` over 10 steps of 5e-3 in both shift modes; the
#: frozen moving gauge wave (v = 0.2, the default amplitude 0.01) on (4, 2)
#: and (8, 2) cells at dx = 1/cells, 4 cells steps to t = 0.08, its L2
#: errors converging at a rate above ``Z4SX_RATE``; flat space with seeded
#: noise of 1e-6 (NumPy seed 1) under the Gamma-driver (κ₁ = 0.5, η = 2) on
#: (4, 4) cells at dx = 0.25 within ``Z4SX_DRIVER`` of itself after 40 steps
#: of 2e-3.
Z4SX_BETA = (0.3, -0.2, 0.1)
Z4SX_STATIONARY = 1e-13
Z4SX_RATE = 2.5
Z4SX_DRIVER = 1e-4
#: K5's float32 bound is ``F32_ULPS`` spacings of max|plain|, as for the
#: other kernels: on this state the plain float32 evaluation of each of a
#: step's five calls is within 1.2-2.3 spacings of max|plain| of the float64
#: one (measured on a CPU at (16, 2, 2), dx = 1/128, where the values are
#: those of the full grid), and the kernel's fused multiply-adds change
#: rounding, not its size.  A wrong term moves values by whole units.

#: H100 SXM data-sheet peaks at 700 W:
#: HBM bytes/s, and float32 flop/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
#: Flops of one Euler flux (1 division, pressure 9, coefficient 1, 4
#: advective products, the pressure term 1, energy 3; rounded up) and one
#: largest wave speed (division, pressure, 3 products, root, 2 sums, 3
#: absolute values, max) in ``csrc/euler.cuh``.
FLUX_OPS = 20
EIG_OPS = 17
#: Flops of one elastic flux of the 9 evolved rows (3 velocity products, 5
#: for the normal stress, 2 for the other normal stresses, 2 shear products
#: and their 3 "+ 0" terms; rounded up) and of one P-wave speed (product,
#: sum, division, root) in ``csrc/elastic.cuh``.
ELASTIC_FLUX_OPS = 16
ELASTIC_EIG_OPS = 4
#: Flops of the viscous flux of all three axes at one node, as
#: ``csrc/navier_stokes.cuh`` shares its terms between the axes (1/ρ 1, the
#: velocity 3, q² 5, T 4; per gradient axis v·∂m 5, ∂v 9, ∂T 8; ∇·v 2; per
#: flux axis τ 8, its 3 signs, the energy row 8), and its 12 sums into the
#: Euler flux.
VISC_FLUX_OPS = 1 + 3 + 5 + 4 + 3 * (5 + 9 + 8) + 2 + 3 * (8 + 3 + 8) + 12
#: Flops of one node's physical gradients: 15 four-point contractions (7
#: each) and 15 divisions by dx.
GRAD_OPS = 15 * 7 + 15
#: Flops the Gassner penalty adds to a face solve: two κ = c·(μ/ρ), their
#: max, the penalty product and the sum.
NS_PENALTY_OPS = 7


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def bench_state(solver, torch, device, dtype):
    """``bench.py:69-76``: numpy default_rng(0), five fixed components."""
    import numpy as np

    rng = np.random.default_rng(0)
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    rho = (1.0 + 0.2 * rng.random(no_var)).astype(np.float32)
    comps = [rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125]
    q = np.stack(comps, axis=va)
    return torch.from_numpy(q).to(device=device, dtype=dtype).contiguous()


def evolved_dofs(sol, rows: int) -> int:
    """Degrees of freedom a step updates: cells · nodes · the ``rows`` that
    evolve (the frozen rows, materials or metric, not counted)."""
    return sol.dofs() // sol.n_vars * rows


def max_err(torch, a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def f32_bound(torch, ref) -> float:
    return F32_ULPS * 2.0**-23 * ref.abs().max().item()


def event_ms(torch, fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(torch, fn, n: int, name: str, per_call: int = 1) -> float:
    """Device time of the kernel ``name`` per call of ``fn`` (``per_call``
    launches each) over ``n`` calls after one warm-up: the mean of the
    kernel's own spans as ``torch.profiler`` records them, times
    ``per_call``, so host time between launches (a wrapper that the host
    calls slower than the card runs it) is not counted.  The profiler may
    drop spans, once even all but one of a window's: a window
    that saw fewer than half of the launches is measured again, and a third
    such window is a failure."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # a process's first window
        fn()                                            # may record nothing
        torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]
        if n * per_call / 2 <= len(spans) <= n * per_call:
            return per_call * sum(spans) / len(spans) / 1e3
        say(f"[profiler] window {attempt + 1}: torch.profiler saw {len(spans)} launches of "
            f"{name}, expected {n * per_call}")
    fail(f"torch.profiler saw {len(spans)} launches of {name}, expected {n * per_call}, in "
         "three windows")


def idle_share(torch, fn) -> tuple[float, float, float]:
    """``(idle share, device busy ms, wall ms)`` of one call of ``fn``.

    Busy is the union of the device intervals of every kernel, copy and
    set that ``torch.profiler`` records (overlaps counted once; no nested
    rows are summed); wall is the host clock from the synchronize before
    ``fn`` to the synchronize after.  The profiler records the device's
    activity only, not the host's operators (an eager Z4 step has ~2e5 of
    them, whose events took longer to gather than the step); its own launch
    overhead still falls into the wall time, so the share is an upper
    bound.  Returns NaNs if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return float("nan"), float("nan"), wall_us / 1e3
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return 1.0 - busy / wall_us, busy / 1e3, wall_us / 1e3


def first_nonfinite(torch, solver, u0, dt, n: int):
    """The first of ``n`` steps from ``u0`` after which the state holds a
    non-finite value, or None."""
    u = u0
    for k in range(1, n + 1):
        u = solver.step(u, dt)
        if not bool(torch.isfinite(u).all()):
            return k
    return None


def windows(torch, solver, u0, dt, steps: int, n_windows: int = 3) -> list[float]:
    """Seconds per step in each window of ``steps`` chained steps from
    ``u0`` (host clock around work that ends in a synchronize)."""
    out = []
    for _ in range(n_windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run(u0, steps, dt)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps)
    return out


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time of a kernel's work on the H100 at 700 W: the larger
    of its bytes over the memory rate and its flops over the f32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return {
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def predictor_ops(order: int, picard_iters: int, ncell: int, dim=3, nvar=5,
                  flux_ops=FLUX_OPS) -> float:
    """Flops of ``aderdg_predictor_volume`` (``csrc/aderdg.cu``), counted per
    (cell, node): each Picard iteration evaluates ``dim`` fluxes per time
    slice and contracts them with D (2n-1 flops per n-point contraction)
    into the right-hand side, then applies K1inv; then the time averages
    of q and the fluxes, the volume integral, and the face projections
    (``dim`` n^(dim-1) of the n^dim threads)."""
    n = order + 1
    contr = 2 * n - 1
    picard = n * (dim * flux_ops + nvar * (1 + dim * (contr + 3))) + n * nvar * contr
    averages = n * (2 * nvar + dim * flux_ops + 2 * dim * nvar)
    volume = nvar * dim * (contr + 2)
    faces = dim * n ** (dim - 1) / n**dim * nvar * 4 * contr
    per_node = picard_iters * picard + averages + volume + faces
    return per_node * n**dim * ncell


def visc_predictor_ops(order: int, picard_iters: int, ncell: int, split: bool = False) -> float:
    """Flops of ``aderdg_predictor_volume_visc`` (``csrc/aderdg_visc.cu``):
    the Euler predictor's (:func:`predictor_ops`), plus per (cell, node)
    and time slice of every Picard iteration and of the time averages the
    gradients and the viscous flux; with the wall split the averages of the
    viscous-only flux (2 flops each of 12 values a slice)."""
    n = order + 1
    visc = GRAD_OPS + VISC_FLUX_OPS
    per_node = picard_iters * n * visc + n * (visc + (24 if split else 0))
    return predictor_ops(order, picard_iters, ncell) + per_node * n**3 * ncell


def visc_predictor_ops_2d(order: int, picard_iters: int, ncell: int,
                          split: bool = False) -> float:
    """Flops of ``aderdg_predictor_volume_visc_2d`` (``csrc/aderdg_2d.cu``):
    the 2-D Euler predictor's (:func:`predictor_ops` in 2-D), plus per
    (cell, node) and time slice of every Picard iteration and of the time
    averages the gradients (8 n-point contractions, 2n - 1 flops each, and
    8 products by 1/dx: 64 at order 3) and the viscous flux; with the
    wall planes the averages of the viscous-only flux (2 flops each of 8
    values a slice)."""
    n = order + 1
    visc = 8 * (2 * n - 1) + 8 + VISC_FLUX_OPS_2D
    per_node = picard_iters * n * visc + n * (visc + (16 if split else 0))
    euler = predictor_ops(order, picard_iters, ncell, dim=2, nvar=4, flux_ops=FLUX_OPS_2D)
    return euler + per_node * n**2 * ncell


def ck_predictor_ops(order: int, ncell: int, dim=3, nvar=12, evolved=CK_EVOLVED,
                     flux_ops=ELASTIC_FLUX_OPS) -> float:
    """Flops of ``aderdg_ck_predictor_volume`` (``csrc/aderdg.cu``; K2 b's
    ``csrc/aderdg_ck_nodes.cuh`` with its own ``flux_ops``), per (cell,
    node): 1/ρ once; each of the N levels evaluates ``dim`` elastic fluxes
    and, per evolved variable, ``dim`` D contractions (2n-1 flops) with
    their λ_d product and sum, the division by k and the q̄ update (2);
    then F̄_d = F_d(q̄), the volume integral and the face projections, as
    in :func:`predictor_ops`."""
    n = order + 1
    contr = 2 * n - 1
    level = dim * flux_ops + evolved * (dim * (contr + 2) + 3)
    volume = nvar * dim * (contr + 2)
    faces = dim * n ** (dim - 1) / n**dim * nvar * 4 * contr
    per_node = 1 + order * level + dim * flux_ops + volume + faces
    return per_node * n**dim * ncell


def ck_sponge_ops(order: int, ncell: int, evolved=CK_EVOLVED) -> float:
    """Flops K2 a adds to :func:`ck_predictor_ops`: dt·(−σ q) and its sum
    (3 flops) per evolved row and node at each of the N levels and once
    more for new = u + dt·S(q̄)."""
    n = order + 1
    return 3 * evolved * (order + 1) * n**3 * ncell


def ck_bytes(state_bytes: int, face_bytes: int) -> int:
    """Bytes of the CK predictor: the state read, the new state and the
    face tensor written."""
    return 2 * state_bytes + face_bytes


def ck_face_bytes(order: int, ncell: int, itemsize: int, dim: int, read: int, rows: int) -> int:
    """Bytes of the face tensor a CK predictor with frozen rows must write:
    per face node of each axis and side, the ``read`` state rows that the
    face flux reads there and the ``rows`` flux rows (the frozen rows' f_lo
    and f_hi, exact zeros that no kernel reads, are not counted)."""
    return dim * (order + 1) ** (dim - 1) * ncell * itemsize * 2 * (read + rows)


def face_surface_ops(order: int, ncell: int, dim=3, nvar=5, eig_ops=EIG_OPS,
                     masked=False) -> float:
    """Flops of the face stage: one Rusanov flux (two wave speeds, 6 flops
    per variable, 7 with a dissipation mask) per interface, that is per face
    node and axis of each cell (:func:`face_flux_ops`), and the surface
    update (:func:`surface_update_ops`)."""
    return (face_flux_ops(order, ncell, dim, nvar, eig_ops, masked)
            + surface_update_ops(order, ncell, dim, nvar))


def face_flux_ops(order: int, ncell: int, dim=3, nvar=5, eig_ops=EIG_OPS,
                  masked=False) -> float:
    """Flops of ``aderdg_face_flux``: one Rusanov flux per interface."""
    n = order + 1
    return ncell * dim * n ** (dim - 1) * (2 * eig_ops + (7 if masked else 6) * nvar)


def surface_update_ops(order: int, ncell: int, dim=3, nvar=5) -> float:
    """Flops of ``aderdg_surface_update``: 5 per node, variable and axis."""
    n = order + 1
    return ncell * n**dim * nvar * dim * 5


def face_stage_bytes(order: int, ncell: int, itemsize: int, dim=3, nvar=5, rows=5) -> int:
    """Bytes of the face stage (the pair of launches, F̂ intermediate): per
    face node of each axis, both faces' state (all ``nvar`` rows, which the
    wave speeds read) and flux (the ``rows`` that can be nonzero) read; the
    ``rows`` that move of the state read and written.  For Euler (``rows ==
    nvar``) that is the whole face tensor and the state read and written."""
    n = order + 1
    faces = dim * n ** (dim - 1) * 2 * (nvar + rows)
    return ncell * itemsize * (faces + 2 * rows * n**dim)


def face_fhat_bytes(face_bytes: int, state_bytes: int, fhat_bytes: int) -> int:
    """Bytes of the face stage with the face-flux output: the faces and the
    state read, the state and the face fluxes written."""
    return face_bytes + 2 * state_bytes + fhat_bytes


def face_flux_bytes(order: int, ncell: int, itemsize: int, dim=3, nvar=5, rows=5) -> int:
    """Bytes of ``aderdg_face_flux``: per interface, both sides' face state
    (the ``nvar`` rows that the flux and the wave speeds read: all of them,
    but for the curvilinear lift, whose axis k reads its wave rows, J and
    J·a^k) and face flux (the ``rows`` that can be nonzero) read, the
    ``rows`` of F̂ written."""
    faces = dim * (order + 1) ** (dim - 1) * ncell
    return faces * itemsize * (2 * nvar + 3 * rows)


def surface_update_bytes(order: int, ncell: int, itemsize: int, dim=3, rows=5) -> int:
    """Bytes of ``aderdg_surface_update``: the ``rows`` that move of the
    state read and written, and F̂ (each interface once) read."""
    n = order + 1
    return ncell * itemsize * rows * (2 * n**dim + dim * n ** (dim - 1))


def kernel_report(cu, name: str, dtype, where: str, ms: float, n_bytes: float,
                  n_ops: float, card: str, info: dict | None = None) -> dict:
    """Print a ``[kernel]`` line for one kernel: how it launches
    (registers, resident blocks per SM, from its library's occupancy query:
    ``cu.kernel_info(name, dtype)`` for a kernel of ``csrc/aderdg.cu``, or
    ``info`` as given; ``cu=None`` and no ``info`` for the face stage's
    pair), its time, the rates it achieved and its bound.  Returns the
    bound."""
    bnd = bound(n_bytes, n_ops)
    shape = "the pair of launches"
    if info is None and cu is not None:
        info = cu.kernel_info(name, dtype)
    if info is not None:
        shape = (f"{info['registers']} registers, {info['blocks_per_sm']} resident blocks of "
                 f"{info['threads']} threads per SM "
                 f"({info['blocks_per_sm'] * info['threads'] // 32} of 64 warps), "
                 f"{info['smem']} B shared memory a block, {info['local']} B local memory "
                 "a thread")
        if "clusters" in info:
            shape += f", {info['clusters']} clusters of 7 blocks resident on the card"
    say(f"[kernel] {name} {where}: {shape}; {ms!r} ms, achieved {n_bytes / ms / 1e9!r} TB/s "
        f"(of {PEAK_BYTES / 1e12}) and {n_ops / ms / 1e9!r} TFLOP/s (of {PEAK_F32 / 1e12}); "
        f"bound {bnd['bound_ms']!r} ms by {bnd['bound_by']} ({n_bytes} B, {n_ops!r} flops), "
        f"{ms / bnd['bound_ms']:.2f}x it ({card})")
    return bnd


def plain_face_flux(torch, sol, faces):
    """The plain version of ``aderdg_face_flux``: ``interface_flux`` of
    every axis, in the kernel's layout ``[dim, n^(dim-1), n_vars, *grid]``."""
    fshape = sol.face_flux_shape
    return torch.stack([
        sol.interface_flux(*(faces[d, k].reshape(fshape) for k in range(4)), d)
        for d in range(sol.dim)
    ]).reshape((sol.dim, -1) + tuple(fshape[-4:]))


def plain_surface_update(sol, new, fhat, dt, walls=None):
    """The plain version of ``aderdg_surface_update`` (a new tensor); with
    walls, ``walls`` maps each wall axis to its low-wall fluxes."""
    for d in range(sol.dim):
        new = sol.surface_term(new, fhat[d].view(sol.face_flux_shape), d, dt,
                               (walls or {}).get(d))
    return new


def kernel_line(name: str, replaces: str, launches: int, err: float, ms: float,
                plain_ms: float, bnd: dict,
                source: str = "exahype_tpu_torch/csrc/aderdg.cu") -> dict:
    """One entry of the kernels JSON for a kernel of ``csrc/aderdg.cu`` (or
    of ``source``)."""
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        **bnd,
        "library_ms": None,  # no single PyTorch call computes it
    }


def sweep_bytes(n_pencils: int, n_cells: int, itemsize: int, n_sub=7, nvar=5) -> int:
    """Bytes one K3 sweep needs: every active pencil's ``n_sub`` subcells
    and two ghosts read and its ``n_sub`` subcells written, and the two
    transverse-mean edge fluxes of each of the batch's ``n_cells`` (k, l)
    cells written (0 in the inactive slots)."""
    return (2 * n_sub + 2) * nvar * itemsize * n_pencils + 2 * nvar * itemsize * n_cells


def sweep_ops(n_pencils: int, n_sub=7, nvar=5) -> float:
    """Flops of one K3 sweep (``csrc/subcell.cu``): per pencil, a flux and
    a wave speed of its ``n_sub + 2`` states, ``n_sub + 1`` Rusanov faces
    (6 flops per variable and a max), the update of ``n_sub`` subcells (3
    per variable), and its share of the two transverse means (1 add per
    variable each)."""
    per_pencil = ((n_sub + 2) * (FLUX_OPS + EIG_OPS) + (n_sub + 1) * (6 * nvar + 1)
                  + n_sub * 3 * nvar + 2 * nvar)
    return per_pencil * n_pencils


def k3_check(torch, subcell_cuda, lim, d, s, lo, hi, n: int, ref, label: str,
             dt=LIMITED_DT, name="subcell_row_sweep", f64_rtol=None) -> float:
    """K3's in-place contract on a clone of ``s`` with ``n`` active slots,
    twice (dt by value, then by pointer): the active slots of ``s`` and of
    the edge fluxes against ``ref`` (the plain sweep of all slots; float64
    at ``F64_ATOL``, or with ``f64_rtol`` at that share of max(1,
    max|plain|), float32 at ``F32_ULPS``), the inactive slots of ``s``
    bitwise its input and the edge fluxes 0 there, the ghosts unchanged,
    the two runs bitwise equal.  Prints one line per output (``name`` the
    kernel's) and fails on any miss; returns the largest error."""
    n_active = torch.tensor(n, device=s.device)
    lo0, hi0 = lo.clone(), hi.clone()
    s1, s2 = s.clone(), s.clone()
    got = subcell_cuda.row_sweep_call(lim, d, s1, lo, hi, dt, n_active)
    again = subcell_cuda.row_sweep_call(
        lim, d, s2, lo, hi, torch.tensor(dt, dtype=s.dtype, device=s.device), n_active)
    torch.cuda.synchronize()
    f64 = s.dtype == torch.float64
    worst = 0.0
    for what, a, b, c in zip(("s", "g_lo", "g_hi"), got, again, ref):
        act = c[..., :n, :]
        err = max_err(torch, a[..., :n, :], act) if n else 0.0
        if f64:
            limit = F64_ATOL if f64_rtol is None else f64_rtol * max(
                1.0, act.abs().max().item() if n else 0.0)
        else:
            limit = f32_bound(torch, act) if n else 0.0
        rest = a[..., n:, :]
        untouched = bool(torch.equal(rest, s[..., n:, :]) if what == "s" else not rest.any())
        repeat = torch.equal(a, b)
        say(f"[parity] {name} d={d} ({what}) {str(s.dtype)[6:]} {label}, "
            f"{n} of {s.shape[-2]} slots active: max_abs_err {err:.3e} limit {limit:.3e}; "
            f"inactive slots {'untouched' if what == 's' else 'zero'} {untouched}; "
            f"repeat bitwise (dt by value, by pointer) {repeat}")
        if not (err <= limit and untouched and repeat):
            fail(f"K3 (d={d}, {what}, {s.dtype}, n_active={n}) breaks its contract")
        worst = max(worst, err)
    if not (got[0] is s1 and torch.equal(lo, lo0) and torch.equal(hi, hi0)):
        fail("K3 did not sweep in place or changed its ghosts")
    return worst


def record_sweeps(lim, u, dt, tables) -> list:
    """``(d, s, ghost_lo, ghost_hi)`` of each sweep of ``lim``'s plain
    gathered step from ``u`` with ``tables`` (the batch as it enters each
    direction)."""
    from exahype_tpu_torch.models.limiter import LimitedADERDG

    recorded = []

    def record(s_, lo_, hi_, d_, dt_):
        recorded.append((d_, s_, lo_, hi_))
        return LimitedADERDG._row_sweep_math(lim, s_, lo_, hi_, d_, dt_)

    lim._row_sweep_math = record
    try:
        lim._gathered_subcell_step_row(u, dt, tables)
    finally:
        del lim._row_sweep_math
    return recorded


def fv_ops(n_patches: int, dim=3, patch=4, halo=1, nvar=5) -> float:
    """Flops the ``fv`` spec's output needs: per axis a flux and a wave
    speed on the cells its face stencil reaches (the interior and the two
    face halos along the axis), then the flux difference (4 flops) and the
    dissipation (10 flops) per variable on the interior."""
    reached = (patch + 2 * halo) * patch ** (dim - 1)
    per_patch = dim * reached * (FLUX_OPS + EIG_OPS) + dim * patch**dim * nvar * (4 + 10)
    return per_patch * n_patches


def fv_bytes(n_patches: int, itemsize: int, dim=3, patch=4, halo=1, nvar=5) -> int:
    """Bytes the ``fv`` spec's output needs: the state on the cells its
    face stencils reach (the interior and the 2·dim face halos) read once,
    and the interior written once.  The edge and corner halos feed nothing,
    and the halos are not written."""
    reached = patch**dim + 2 * dim * halo * patch ** (dim - 1)
    return (reached + patch**dim) * nvar * itemsize * n_patches


def fv_state(torch, grid, device, dtype, seed=0):
    """``__graft_entry__._example_state``'s recipe (``:31-36``) on the
    SoA-P grid state ``[6, 6, 6, 5, *grid]``: uniform(0.1, 1) from numpy
    ``default_rng(seed)``, +1 on the density, +5 on the energy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = rng.uniform(0.1, 1.0, size=(6, 6, 6, 5) + tuple(grid)).astype(np.float32)
    q[:, :, :, 0] += 1.0
    q[:, :, :, 4] += 5.0
    return torch.from_numpy(q).to(device=device, dtype=dtype).contiguous()


def spec_mask(torch, q, cells):
    """A boolean ``[*extent, n_vars]`` mask of a K4 printer's ``(cell,
    var)`` set, on ``q``'s device."""
    mask = torch.zeros(q.shape[:4], dtype=torch.bool, device=q.device)
    for cell, v in cells:
        mask[cell + (v,)] = True
    return mask


def interior_mass(torch, u):
    """Sum of each conserved variable over the patch interiors (float64)."""
    return u[1:5, 1:5, 1:5].double().sum(dim=(0, 1, 2, 4, 5, 6))


def sod_state(solver, torch, device, dtype):
    """``bench.py:348-356``: the Sod shock along axis 0, at rest."""
    import numpy as np

    grid = solver.grid_shape
    x = np.arange(grid[0]).reshape(-1, 1, 1) / grid[0]
    left = np.broadcast_to(x < 0.5, grid)
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    rho = np.broadcast_to(np.where(left, 1.0, 0.125), no_var).astype(np.float32)
    p = np.broadcast_to(np.where(left, 1.0, 0.1), no_var).astype(np.float32)
    zeros = np.zeros(no_var, np.float32)
    q = np.stack([rho, zeros, zeros, zeros, p / 0.4], axis=va)
    return torch.from_numpy(q).to(device=device, dtype=dtype).contiguous()


def limited_path(torch, dev, card) -> list[dict]:
    """The limited form of the main path; returns the kernel JSON lines of
    the face stage with its face-flux output and of K3."""
    import numpy as np

    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    flux, eig = euler_physics(3, n_real=5)
    adm = euler_admissible(3)

    def make(grid, dtype, dx=DX):
        sol = ADERDGSolver(3, ORDER, 5, grid, flux, eig, dx=dx, device=dev, dtype=dtype)
        cu = CudaADERDG(sol)
        opts = dict(troubled_capacity=CAPACITY, troubled_granularity="row",
                    dmp_delta0=DMP_DELTA0, device=dev)
        kernel = LimitedADERDG(sol, adm, accelerator=cu, subcell_cuda=True, **opts)
        plain = LimitedADERDG(sol, adm, **opts)
        return sol, cu, kernel, plain

    # --------------------------------- the face stage's face fluxes vs plain
    fhat_err = 0.0
    for grid, dtype in (((8, 4, 32), torch.float64), (GRID, torch.float32)):
        sol, cu, _, _ = make(grid, dtype)
        u = bench_state(sol, torch, dev, dtype) if dtype == torch.float64 else (
            sod_state(sol, torch, dev, dtype))
        new, faces, _ = sol.predictor_volume(u, LIMITED_DT)
        out_k, fl_k = cu.face_surface(new.clone(), faces, LIMITED_DT, return_face_fluxes=True)
        out_p, fl_p = sol.face_surface(new, faces, LIMITED_DT, return_face_fluxes=True)
        torch.cuda.synchronize()
        f64 = dtype == torch.float64
        for what, got, ref in [("new", out_k, out_p)] + [
                (f"fhat[{d}]", a, b) for d, (a, b) in enumerate(zip(fl_k, fl_p))]:
            err = max_err(torch, got, ref)
            limit = F64_ATOL if f64 else f32_bound(torch, ref)
            say(f"[parity] face stage with face fluxes ({what}) "
                f"{str(dtype)[6:]} {grid}: max_abs_err {err:.3e} limit {limit:.3e}")
            if not err <= limit:
                fail(f"the face stage's {what} disagrees with its plain version")
            if not f64:
                fhat_err = max(fhat_err, err)
        del sol, cu, u, new, faces, out_k, fl_k, out_p, fl_p, got, ref

    # --------------------------------- K3 vs plain, float64, small batch
    _, _, lim64, _ = make((4, 2, 8), torch.float64)
    rng = np.random.default_rng(0)

    def pencils(shape):
        lead = shape[:3] + shape[4:]
        q = np.stack([1.0 + 0.3 * rng.random(lead)]
                     + [0.4 * rng.standard_normal(lead) for _ in range(3)]
                     + [2.5 + rng.random(lead)], axis=3)
        return torch.from_numpy(q).to(dev).contiguous()

    for d in range(3):
        gshape = [7, 7, 7, 5, 8, 16]
        gshape[d] = 1
        s, lo, hi = pencils((7, 7, 7, 5, 8, 16)), pencils(tuple(gshape)), pencils(tuple(gshape))
        ref = lim64._row_sweep_math(s, lo, hi, d, LIMITED_DT)
        for n in (3, 8):
            k3_check(torch, subcell_cuda, lim64, d, s, lo, hi, n, ref, "K=8 L=16")
    del lim64, s, lo, hi, ref

    # --------------------------------- the limited main path
    sol, cu, lim, plain = make(GRID, torch.float32)
    u0 = sod_state(sol, torch, dev, torch.float32)
    say(f"[limited] dt = {LIMITED_DT!r} (bench.py:356); cfl_dt(initial state) = "
        f"{float(sol.cfl_dt(u0))!r}; capacity {CAPACITY} rows of {GRID[-1]} cells, "
        f"dmp_delta0 {DMP_DELTA0}")
    u5 = lim.run(u0, WARMUP, LIMITED_DT)
    torch.cuda.synchronize()
    if not torch.isfinite(u5).all():
        fail("the limited state is not finite after the warm-up")

    # K3 on the gathered batch of this state, float32: record the sweeps'
    # inputs of one plain step.
    candidate = cu.step(u5, LIMITED_DT)
    tables = plain._gather_tables_row(plain.troubled_mask(u5, candidate))
    n_active = int(tables["n_active"])
    recorded = record_sweeps(plain, u5, LIMITED_DT, tables)
    del candidate
    # The kernel's times in place, on a working copy: at the batch's own
    # n_active and with every slot active (the overflow's worst case).
    # Device time from the profiler (a sweep at 16 rows is shorter than the
    # wrapper's host time, so CUDA events around back-to-back calls would
    # time the host); the events' per-call time is printed beside it.
    k3_err, k3_ms, k3_full_ms, k3_call_ms, k3_plain_ms = 0.0, {}, {}, {}, {}
    n_dev, all_dev = tables["n_active"], torch.tensor(CAPACITY, device=dev)
    for d, s, lo, hi in recorded:
        ref = plain._row_sweep_math(s, lo, hi, d, LIMITED_DT)
        label = f"{tuple(s.shape)} (gathered batch after {WARMUP} steps)"
        k3_err = max(k3_err, k3_check(torch, subcell_cuda, lim, d, s, lo, hi, n_active, ref,
                                      label))
        k3_check(torch, subcell_cuda, lim, d, s, lo, hi, CAPACITY, ref, label)
        work = s.clone()

        def sweep(n_):
            return subcell_cuda.row_sweep_call(lim, d, work, lo, hi, LIMITED_DT, n_)

        k3_ms[d] = device_ms(torch, lambda: sweep(n_dev), 20, "subcell_row_sweep")
        k3_call_ms[d] = event_ms(torch, lambda: sweep(n_dev), 20)
        work.copy_(s)
        k3_full_ms[d] = device_ms(torch, lambda: sweep(all_dev), 20, "subcell_row_sweep")
        k3_plain_ms[d] = event_ms(torch, lambda: plain._row_sweep_math(
            s, lo, hi, d, LIMITED_DT), 3)
        del ref, work
    sweep_shape = tuple(recorded[0][1].shape)
    del recorded, s, lo, hi

    gib = 2.0**-30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cu.reset_launches()
    subcell_cuda.reset_launches()
    u = lim.run(u5, STEPS, LIMITED_DT)
    torch.cuda.synchronize()
    launches = {**cu.launches, **subcell_cuda.launches}
    say(f"[limited main] {STEPS} steps of {GRID} f32 through LimitedADERDG after "
        f"{WARMUP} warm-up steps: launches {launches}; peak "
        f"{torch.cuda.max_memory_allocated() * gib:.4f} GiB allocated ({card})")
    want = {**{name: 0 for name in subcell_cuda.launches},
            **{name: STEPS for name in cu.kernels}, "subcell_row_sweep": 3 * STEPS}
    if launches != want:
        fail(f"limited main path launches {launches}, expected {want}")
    finite = bool(torch.isfinite(u).all())
    admissible = bool(adm(u, sol.var_axis).all())
    rho_min = u.select(sol.var_axis, 0).min().item()
    say(f"[limited main] full state finite {finite}, admissible {admissible}, "
        f"rho_min {rho_min!r}")
    if tuple(u.shape) != sol.state_shape or not (finite and admissible):
        fail("the limited main-path state is not finite and admissible")

    # Rows demanded at each checked step, from a second run from the same
    # state (which must give the same bits).
    demand, v = [], u5
    for _ in range(STEPS):
        demand.append(int(lim.capacity_usage(v, LIMITED_DT)[0]))
        v = lim.step(v, LIMITED_DT)
    overflow = max(demand) > CAPACITY
    say(f"[limited main] troubled rows demanded per step {demand} against capacity "
        f"{CAPACITY}: overflow engaged {overflow}")
    if not torch.equal(u, v):
        fail("two limited runs from the same state differ")
    say("[limited main] two runs from the same state: bitwise equal")
    del v
    m0, m1 = sol.total_mass(u5.double()), sol.total_mass(u.double())
    rel = ((m1 - m0).abs() / m0.abs()).tolist()
    say(f"[limited main] relative drift over {STEPS} steps: mass {rel[0]:.3e}, energy "
        f"{rel[4]:.3e}; momenta absolute {[(m1 - m0)[k].item() for k in (1, 2, 3)]} "
        f"(limit {MASS_RTOL:.1e} on the mass when no overflow engaged)")
    if not overflow and not rel[0] <= MASS_RTOL:
        fail("limited mass drift beyond its bound")

    # One step of the kernel path against the plain path from this state.
    mask_k = lim.troubled_mask(u, cu.step(u, LIMITED_DT))
    mask_p = plain.troubled_mask(u, sol.step(u, LIMITED_DT))
    step_k, step_p = lim.step(u, LIMITED_DT), plain.step(u, LIMITED_DT)
    torch.cuda.synchronize()
    err, limit = max_err(torch, step_k, step_p), f32_bound(torch, step_p)
    say(f"[limited main] one step, kernel path vs plain path: troubled cells "
        f"{int(mask_k.sum())} (kernel candidate) / {int(mask_p.sum())} (plain), masks "
        f"equal {torch.equal(mask_k, mask_p)}; state max_abs_err {err:.3e} limit {limit:.3e}")
    if not (torch.equal(mask_k, mask_p) and err <= limit):
        fail("the limited kernel path disagrees with the plain path")

    # Poison: the same kernel step with every inactive slot of the gathered
    # batch and its ghosts NaN before each sweep, and of its edge fluxes
    # after, must give the same bits: nothing reads an inactive slot.
    real_sweep, seen = subcell_cuda.row_sweep_call, []

    def poisoned(limiter, d, s, lo, hi, dt, n_active):
        n = int(n_active)
        seen.append((n, s.shape[-2]))
        for x in (s, lo, hi):
            x[..., n:, :] = float("nan")
        s, g_lo, g_hi = real_sweep(limiter, d, s, lo, hi, dt, n_active)
        g_lo[:, n:] = float("nan")
        g_hi[:, n:] = float("nan")
        return s, g_lo, g_hi

    subcell_cuda.row_sweep_call = poisoned
    try:
        step_nan = lim.step(u, LIMITED_DT)
    finally:
        subcell_cuda.row_sweep_call = real_sweep
    torch.cuda.synchronize()
    same = torch.equal(step_nan, step_k)
    say(f"[limited main] poison: one kernel step with the inactive slots of the gathered "
        f"batch, its ghosts and its edge fluxes NaN ((n_active, K) of each sweep: {seen}): "
        f"bitwise equal to the ordinary step {same}")
    if not (same and len(seen) == 3 and seen[0][0] < seen[0][1]):
        fail("the poisoned limited step differs, or poisoned no slot")
    del mask_k, mask_p, step_k, step_p, step_nan

    # ------------------------------------------------ times
    dofs = sol.dofs()
    k_win = windows(torch, lim, u5, LIMITED_DT, steps=STEPS)
    p_win = windows(torch, plain, u5, LIMITED_DT, steps=2, n_windows=1)
    for label, win in (("kernel path", k_win), ("plain path", p_win)):
        ms = [1e3 * w for w in win]
        say(f"[limited time] {label}: step ms per window {ms!r}; median "
            f"{statistics.median(ms)!r} ms, {dofs / statistics.median(win)!r} "
            f"DOF-updates/s ({dofs} DOF per step; {card})")
    new, faces, _ = cu.predictor_volume(u5, LIMITED_DT)
    fhat, _ = cu.face_flux(faces)
    parts = {
        "aderdg_predictor_volume": event_ms(
            torch, lambda: cu.predictor_volume(u5, LIMITED_DT), 10),
        "face stage (no face fluxes)": event_ms(
            torch, lambda: cu.face_surface(new, faces, LIMITED_DT), 10),
        "face stage (face fluxes)": event_ms(
            torch, lambda: cu.face_surface(new, faces, LIMITED_DT, True), 10),
        **{f"subcell_row_sweep d={d}": k3_ms[d] for d in range(3)},
    }
    # The face stage's launches alone, as the limited step makes them.
    launch_ms = {
        "aderdg_predictor_volume": parts["aderdg_predictor_volume"],
        "aderdg_face_flux": event_ms(torch, lambda: cu.face_flux(faces), 10),
        "aderdg_surface_update": event_ms(
            torch, lambda: cu.surface_update(new, fhat, LIMITED_DT), 10),
    }
    face_plain_ms = event_ms(torch, lambda: sol.face_surface(new, faces, LIMITED_DT, True), 3)
    step_ms = event_ms(torch, lambda: lim.step(u5, LIMITED_DT), 10)
    rest = step_ms - sum(v for k, v in parts.items() if "no face" not in k)
    say(f"[limited time] per call (CUDA events): " + ", ".join(
        f"{k} {v!r} ms" for k, v in parts.items()) + f"; whole step {step_ms!r} ms, "
        f"of which the rest of the step (detection, tables, gathers, projections, "
        f"ghosts, scatters, matching, guard) {rest!r} ms ({card})")
    say(f"[limited time] plain versions (CUDA events): face_surface with face fluxes "
        f"{face_plain_ms!r} ms; sweeps " + ", ".join(
            f"d={d} {k3_plain_ms[d]!r} ms" for d in range(3)) + f" ({card})")
    del new, faces, fhat

    # The step's stages one by one on this state (CUDA events); the
    # fallback scatter is idempotent, so it is timed in place.
    cand, dg_fl = cu.step(u5, LIMITED_DT, return_face_fluxes=True)
    raw = lim.troubled_mask(u5, cand)
    tab = lim._gather_tables_row(raw)
    R, g = lim._gathered_subcell_step_row(u5, LIMITED_DT, tab)
    fv = lim._scatter_face_fluxes_row(g, tab, u5.dtype)
    matched = lim._match_interface_fluxes(cand, dg_fl, fv, tab["mask"], LIMITED_DT)
    stages = {
        "troubled_mask": lambda: lim.troubled_mask(u5, cand),
        "_gather_tables_row": lambda: lim._gather_tables_row(raw),
        "_gathered_subcell_step_row (3 sweeps included)":
            lambda: lim._gathered_subcell_step_row(u5, LIMITED_DT, tab),
        "_scatter_face_fluxes_row": lambda: lim._scatter_face_fluxes_row(g, tab, u5.dtype),
        "_match_interface_fluxes": lambda: lim._match_interface_fluxes(
            cand, dg_fl, fv, tab["mask"], LIMITED_DT),
        "_scatter_fallback_row": lambda: lim._scatter_fallback_row(
            matched, R, tab, tab["mask"]),
        "overflow flag": lambda: bool((raw & ~tab["mask"]).any()),
        "_admissibility_scale": lambda: lim._admissibility_scale(matched),
    }
    stage_ms = {k: event_ms(torch, fn, 5) for k, fn in stages.items()}
    in_step = device_ms(torch, lambda: lim.step(u5, LIMITED_DT), 3, "subcell_row_sweep", 3)
    say(f"[limited time] the step's stages alone (CUDA events, 5 calls each): " + ", ".join(
        f"{k} {v!r} ms" for k, v in stage_ms.items()) + f"; sweeps {sum(k3_ms.values())!r} "
        f"ms of the gathered step (device time alone), {in_step!r} ms a step inside the "
        f"step (torch.profiler, 3 steps) ({card})")
    del cand, dg_fl, raw, tab, R, g, fv, matched

    # Host synchronisations of one step, and where the port's code makes
    # them (torch.cuda's sync debug mode warns at each; switching it on
    # warns once itself, which is not counted).
    import traceback
    import warnings

    sites = []

    def where_synced(message, *args, **kwargs):
        if "synchroniz" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]
                    if pathlib.Path(f.filename).resolve().is_relative_to(HERE)]
            sites.append(f"{pathlib.Path(ours[-1].filename).resolve().relative_to(HERE)}:"
                         f"{ours[-1].lineno}" if ours else "no frame of this repository")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = where_synced
        torch.cuda.set_sync_debug_mode("warn")
        sites.clear()
        try:
            lim.step(u5, LIMITED_DT)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for label, solver, n in (("kernel path", lim, STEPS), ("plain path", plain, 2)):
        idle, busy, wall = idle_share(torch, lambda: solver.run(u5, n, LIMITED_DT))
        say(f"[limited idle] {label}, {n} steps under torch.profiler: device busy "
            f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")
    say(f"[limited time] host synchronisations per kernel-path step "
        f"(torch.cuda sync debug mode): {len(sites)}, at {sites}")

    # ------------------------------------------------ bounds
    itemsize = u5.element_size()
    ncell = math.prod(GRID)
    face_bytes = torch.empty(sol.face_shape, dtype=u5.dtype, device="meta").nbytes
    fhat_bytes = 3 * sol.n_nodes**2 * sol.n_vars * ncell * itemsize
    state_bytes = u5.nbytes
    work = {
        "aderdg_predictor_volume": (2 * state_bytes + face_bytes,
                                    predictor_ops(ORDER, sol.picard_iters, ncell)),
        "aderdg_face_flux": (face_flux_bytes(ORDER, ncell, itemsize),
                             face_flux_ops(ORDER, ncell)),
        "aderdg_surface_update": (surface_update_bytes(ORDER, ncell, itemsize),
                                  surface_update_ops(ORDER, ncell)),
    }
    for name in cu.kernels:
        kernel_report(cu, name, torch.float32, f"(Euler, limited path) {GRID} f32",
                      launch_ms[name], *work[name], card)
    face_bnd = kernel_report(
        None, "face stage with face fluxes", torch.float32, f"(Euler, limited path) {GRID} f32",
        parts["face stage (face fluxes)"], face_fhat_bytes(face_bytes, u5.nbytes, fhat_bytes),
        face_surface_ops(ORDER, ncell), card)
    k3_info = subcell_cuda.kernel_info(torch.float32)
    n_cells = sweep_shape[4] * sweep_shape[5]
    k3_work = {
        what: (sweep_bytes(49 * rows * GRID[-1], n_cells, itemsize),
               sweep_ops(49 * rows * GRID[-1]), statistics.mean(ms.values()))
        for what, rows, ms in ((f"{n_active} active slots", n_active, k3_ms),
                               (f"all {CAPACITY} slots active", CAPACITY, k3_full_ms))
    }
    k3_bnds = {
        what: kernel_report(None, "subcell_row_sweep", torch.float32,
                            f"(limited path, {what}) {sweep_shape} f32, mean of 3 directions",
                            ms, n_bytes, n_ops, card, info=k3_info)
        for what, (n_bytes, n_ops, ms) in k3_work.items()
    }
    k3_bnd, k3_bnd_full = k3_bnds.values()
    say(f"[bound] subcell_row_sweep f32, one sweep (device time, torch.profiler): "
        f"{n_active} active slots: kernel mean {statistics.mean(k3_ms.values())!r} ms (per "
        f"direction {list(k3_ms.values())!r}) against a bound of {k3_bnd['bound_ms']!r} ms "
        f"by {k3_bnd['bound_by']}; all {CAPACITY} slots active: kernel mean "
        f"{statistics.mean(k3_full_ms.values())!r} ms (per direction "
        f"{list(k3_full_ms.values())!r}) against {k3_bnd_full['bound_ms']!r} ms; per call "
        f"through the wrapper at {n_active} active slots (CUDA events, back to back) "
        f"{list(k3_call_ms.values())!r} ms ({card})")
    return [
        kernel_line("aderdg_face_flux + aderdg_surface_update (face stage with face fluxes, "
                    "limited path)", "exahype_tpu/models/aderdg_pallas.py:156",
                    launches["aderdg_surface_update"], fhat_err,
                    parts["face stage (face fluxes)"], face_plain_ms, face_bnd),
        {
            "name": "subcell_row_sweep",
            "route": "cuda",
            "source": "exahype_tpu_torch/csrc/subcell.cu",
            "replaces": "exahype_tpu/models/subcell_pallas.py:47",
            "launches": launches["subcell_row_sweep"],
            "max_abs_err": k3_err,
            "ms": statistics.mean(k3_ms.values()),
            "plain_ms": statistics.mean(k3_plain_ms.values()),
            **k3_bnd,
            "library_ms": None,  # no single PyTorch call computes it
        },
    ]


def ck_path(torch, dev, card) -> list[dict]:
    """The CK form of the main path; returns the kernel JSON lines of K2,
    of the face stage's elastic variant and of its two kernels (at
    ``(256, 8, 128)``)."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import ADERDGSolver
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.elastic import (
        DISSIPATION_MASK,
        MATERIAL_SLOTS,
        N_VARS_3D_HET,
        elastic3d_heterogeneous,
        seismic_energy,
        two_layer_state,
    )

    flux, eig = elastic3d_heterogeneous()
    E = CK_EVOLVED

    def make(grid, dtype):
        sol = ADERDGSolver(3, ORDER, N_VARS_3D_HET, grid, flux, eig, dx=1.0 / grid[0],
                           device=dev, dtype=dtype, predictor_mode="ck",
                           ck_material_slots=MATERIAL_SLOTS,
                           dissipation_mask=DISSIPATION_MASK)
        return sol, CudaADERDG(sol)

    def initial(sol, dtype):
        q, mat = two_layer_state(sol)
        return (torch.from_numpy(q).to(dev, dtype).contiguous(),
                torch.from_numpy(np.ascontiguousarray(mat)).to(dev, dtype))

    def mats(q, va=3):
        return q.narrow(va, E, N_VARS_3D_HET - E)

    def frozen(q, mat):
        return torch.equal(mats(q), mat)  # values: -0.0 == 0.0

    # ------------------------------- K2 and the elastic face stage vs plain
    errs = {name: 0.0 for name in ("aderdg_ck_predictor_volume", "face stage",
                                   "aderdg_face_flux", "aderdg_surface_update")}
    for grid, dtype in (((8, 4, 32), torch.float64),) + tuple(
            (g, torch.float32) for g in CK_GRIDS):
        sol, cu = make(grid, dtype)
        u, mat = initial(sol, dtype)
        dt = CK_DT if grid[0] <= 64 else float(sol.cfl_dt(u))
        u_in = u.clone()
        new_k, faces_k, _ = cu.predictor_volume(u, dt)
        new_p, faces_p, _ = sol.predictor_volume(u, dt)
        surf_k = cu.face_surface(new_p.clone(), faces_p, dt)
        surf_p = sol.face_surface(new_p, faces_p, dt)
        # F̂ as the face stage returns it: aderdg_face_flux leaves the
        # material rows unwritten, and the wrapper zeroes them.
        surf_f, fl_k = cu.face_surface(new_p.clone(), faces_p, dt, return_face_fluxes=True)
        fhat_p = plain_face_flux(torch, sol, faces_p)
        fhat_k = torch.stack(fl_k).view(fhat_p.shape)
        upd_k = cu.surface_update(new_p.clone(), fhat_p, dt)
        upd_p = plain_surface_update(sol, new_p, fhat_p, dt)
        step_k = cu.step(u, dt)
        step_p = sol.step(u, dt)
        torch.cuda.synchronize()
        if not torch.equal(u, u_in):
            fail("the CK step modified its input")
        f64 = dtype == torch.float64
        for name, what, got, ref, va in (
            ("aderdg_ck_predictor_volume", "new", new_k, new_p, 3),
            ("aderdg_ck_predictor_volume", "faces", faces_k, faces_p, 3),
            ("face stage", "new", surf_k, surf_p, 3),
            ("aderdg_face_flux", "fhat", fhat_k, fhat_p, 2),
            ("aderdg_surface_update", "new", upd_k, upd_p, 3),
            ("step", "new", step_k, step_p, 3),
        ):
            # The evolved rows against the bound of their own largest value,
            # the material rows against theirs (the wave is ~1e-3, the
            # materials up to 3; their face fluxes are zero).
            for rows, lo, n in (("evolved", 0, E), ("material", E, N_VARS_3D_HET - E)):
                g, r = got.narrow(va, lo, n), ref.narrow(va, lo, n)
                err = max_err(torch, g, r)
                limit = F64_ATOL if f64 else f32_bound(torch, r)
                ok = err <= limit
                say(f"[ck parity] {name} ({what}, {rows} rows) {str(dtype)[6:]} {grid}: "
                    f"max_abs_err {err:.3e} limit {limit:.3e} "
                    f"({'atol' if f64 else f'{F32_ULPS} f32 spacings of max|plain|'}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"CK {name} ({what}, {rows} rows) disagrees with its plain "
                         f"version ({dtype}, {grid})")
                if name in errs and not f64 and grid == CK_GRIDS[-1]:
                    errs[name] = max(errs[name], err)
        exact = {
            "predictor new": frozen(new_k, mat), "face-stage new": frozen(surf_k, mat),
            "surface-update new": frozen(upd_k, mat), "step": frozen(step_k, mat),
            "material flux rows of the faces zero": not bool(mats(faces_k[:, 2:], 3).any()),
            "material rows of the returned face fluxes zero": not bool(mats(fhat_k, 2).any()),
            "face-stage new with face fluxes bitwise equal": torch.equal(surf_f, surf_k),
        }
        say(f"[ck parity] kernel materials {str(dtype)[6:]} {grid}: {exact}")
        if not all(exact.values()):
            fail(f"the CK kernels moved the material slots, wrote nonzero material fluxes or "
                 f"changed bits with the face-flux output ({dtype}, {grid})")
        del sol, cu, u, u_in, mat, new_k, faces_k, new_p, faces_p, surf_k, surf_p
        del surf_f, fl_k, fhat_k, fhat_p, upd_k, upd_p, step_k, step_p, got, ref, g, r
        torch.cuda.empty_cache()

    # ------------------------------- the main path at both grids
    lines = None
    for grid in CK_GRIDS:
        sol, cu = make(grid, torch.float32)
        u0, mat = initial(sol, torch.float32)
        e = lambda q: float(seismic_energy(q.double(), 3, mat.double()))  # noqa: E731
        bench_grid = grid == CK_GRIDS[0]
        cfl = float(sol.cfl_dt(u0))
        dt = CK_DT if bench_grid else cfl
        warm, steps = (CK_WARMUP, CK_WINDOW) if bench_grid else (0, STEPS)
        say(f"[ck] {grid}: dt = {dt!r} ({'bench.py:204' if bench_grid else 'cfl_dt'}); "
            f"cfl_dt(initial state) = {cfl!r}; {warm} warm-up steps, then {steps}")
        ustart = cu.run(u0, warm, dt)
        torch.cuda.synchronize()
        half = steps // 2
        cu.reset_launches()
        mid = cu.run(ustart, half, dt)
        u = cu.run(mid, steps - half, dt)
        torch.cuda.synchronize()
        launches = dict(cu.launches)
        say(f"[ck main] {steps} steps of {grid} f32 through CudaADERDG: launches {launches}")
        want = {name: steps for name in cu.kernels}
        if launches != want:
            fail(f"CK main path launches {launches}, expected {want}")
        finite, is_frozen = bool(torch.isfinite(u).all()), frozen(u, mat)
        e0, em, e1 = e(ustart), e(mid), e(u)
        say(f"[ck main] full state finite {finite}; slots 9-11 bitwise equal to the "
            f"initial materials {is_frozen}; seismic energy ratio {e1 / e0!r} over the "
            f"{steps} steps (first half {em / e0!r}, second half {e1 / em!r}); gate "
            f"{CK_ENERGY_GATE} (bench.py:280){' applied' if bench_grid else ', read only'}")
        if tuple(u.shape) != sol.state_shape or not (finite and is_frozen):
            fail("the CK main-path state is not finite or its materials moved")
        if bench_grid and not e1 / e0 < CK_ENERGY_GATE:
            fail(f"the CK seismic energy grew by {e1 / e0} over the bench's window")
        again = cu.run(ustart, steps, dt)
        if not torch.equal(u, again):
            fail("two CK runs from the same state differ")
        say("[ck main] two runs from the same state: bitwise equal")
        del again, mid
        plain_u = sol.run(ustart, steps, dt)
        run_err = max_err(torch, u.narrow(3, 0, E), plain_u.narrow(3, 0, E))
        run_bound = steps * f32_bound(torch, plain_u.narrow(3, 0, E))
        plain_frozen = frozen(plain_u, mat)
        say(f"[ck main] {steps}-step kernel path vs plain path (evolved rows): max_abs_err "
            f"{run_err:.3e} limit {run_bound:.3e}; plain path's materials frozen "
            f"{plain_frozen}; plain energy ratio {e(plain_u) / e0!r}")
        if not (run_err <= run_bound and plain_frozen):
            fail("the CK main path disagrees with the plain path")
        del plain_u

        # ------------------------------------------------ times
        ncell = math.prod(grid)
        evolved_dofs = ncell * sol.n_nodes**3 * E
        k_win = windows(torch, cu, ustart, dt, steps=20)
        p_win = windows(torch, sol, ustart, dt, steps=2, n_windows=1)
        for label, win in (("kernel path", k_win), ("plain path", p_win)):
            ms = [1e3 * w for w in win]
            say(f"[ck time] {grid} {label}: step ms per window {ms!r}; median "
                f"{statistics.median(ms)!r} ms, {evolved_dofs / statistics.median(win)!r} "
                f"evolved-DOF-updates/s ({evolved_dofs} evolved DOF per step; {card})")
        new, faces, _ = cu.predictor_volume(ustart, dt)
        fhat, _ = cu.face_flux(faces)
        times = {
            "aderdg_ck_predictor_volume": (
                event_ms(torch, lambda: cu.predictor_volume(ustart, dt), 20),
                event_ms(torch, lambda: sol.predictor_volume(ustart, dt), 3),
            ),
            "face stage": (
                event_ms(torch, lambda: cu.face_surface(new, faces, dt), 20),
                event_ms(torch, lambda: sol.face_surface(new, faces, dt), 3),
            ),
            "aderdg_face_flux": (
                event_ms(torch, lambda: cu.face_flux(faces), 20),
                event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3),
            ),
            "aderdg_surface_update": (
                event_ms(torch, lambda: cu.surface_update(new, fhat, dt), 20),
                event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt), 3),
            ),
        }
        for name, (ms, plain_ms) in times.items():
            say(f"[ck time] {grid} {name}: kernel {ms!r} ms, plain {plain_ms!r} ms "
                f"(CUDA events; {card})")
        del new, fhat
        for label, solver, n in (("kernel path", cu, 20), ("plain path", sol, 2)):
            idle, busy, wall = idle_share(torch, lambda: solver.run(ustart, n, dt))
            say(f"[ck idle] {grid} {label}, {n} steps under torch.profiler: device busy "
                f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")
        # The face stage's bound is the pair's; it and its kernels' count
        # only the rows their work needs (no flux and no update of the
        # frozen materials).
        state_bytes = ustart.nbytes
        face_bytes = faces.nbytes
        itemsize = ustart.element_size()
        elastic = dict(nvar=N_VARS_3D_HET, eig_ops=ELASTIC_EIG_OPS, masked=True)
        work = {
            "aderdg_ck_predictor_volume": (ck_bytes(state_bytes, face_bytes),
                                           ck_predictor_ops(ORDER, ncell)),
            "aderdg_face_flux": (
                face_flux_bytes(ORDER, ncell, itemsize, nvar=N_VARS_3D_HET, rows=E),
                face_flux_ops(ORDER, ncell, **elastic)),
            "aderdg_surface_update": (surface_update_bytes(ORDER, ncell, itemsize, rows=E),
                                      surface_update_ops(ORDER, ncell, nvar=E)),
            "face stage": (
                face_stage_bytes(ORDER, ncell, itemsize, nvar=N_VARS_3D_HET, rows=E),
                face_surface_ops(ORDER, ncell, **elastic)),
        }
        del faces
        bounds = {
            name: kernel_report(None if name == "face stage" else cu, name, torch.float32,
                                f"(CK, elastic) {grid} f32", times[name][0], *work[name], card)
            for name in (*cu.kernels, "face stage")
        }
        if grid != CK_GRIDS[-1]:
            continue
        # The kernels at the grid where the card is the limit.
        replaces = {"aderdg_ck_predictor_volume": "exahype_tpu/models/aderdg_pallas.py:358"}
        lines = [
            kernel_line(name, replaces.get(name, "exahype_tpu/models/aderdg_pallas.py:156"),
                        launches[name], errs[name], *times[name], bounds[name])
            for name in cu.kernels
        ]
        lines.append(kernel_line(
            "aderdg_face_flux + aderdg_surface_update (face stage, 12-var elastic, "
            "dissipation mask, CK path)", "exahype_tpu/models/aderdg_pallas.py:156",
            launches["aderdg_surface_update"], errs["face stage"], *times["face stage"],
            bounds["face stage"]))
    return lines


def seismic_setup(torch, dev, grid, dtype):
    """``examples/seismic3d_layered.py:51-112`` at ``grid``: the CK
    heterogeneous-elastic solver with the free surface on axis 2 and the
    sponge, ``CudaADERDG`` over it, the layered state at rest, the Ricker
    point force, the receivers (in the state's dtype), the probe, the
    path's dt (``cfl_dt`` of the initial state at ``SEIS_CFL``) and the
    example's (at the default cfl), each a Python float as the example takes
    it, and the depth of the box."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import ADERDGSolver
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.elastic import (
        DISSIPATION_MASK,
        MATERIAL_SLOTS,
        N_VARS_3D_HET,
        elastic3d_free_surface_het,
        elastic3d_heterogeneous,
        sponge_source,
    )
    from exahype_tpu_torch.models.point_source import PointSources, ricker
    from exahype_tpu_torch.models.tracers import TracerAdvector

    flux, eig = elastic3d_heterogeneous()
    reflect, reflect_flux = elastic3d_free_surface_het()
    sol = ADERDGSolver(3, ORDER, N_VARS_3D_HET, grid, flux, eig, dx=1.0 / grid[0], device=dev,
                       dtype=dtype, boundary="reflective", wall_axes=(2,), reflect_fn=reflect,
                       reflect_flux_fn=reflect_flux, dissipation_mask=DISSIPATION_MASK,
                       predictor_mode="ck", ck_material_slots=MATERIAL_SLOTS)
    sol.source_fn = sponge_source(sol, **SEIS_SPONGE)
    no_var = sol.state_shape[:3] + sol.state_shape[4:]
    zc = np.broadcast_to(np.squeeze(sol.nodes_meshgrid()[2], 3), no_var)
    zmax = grid[2] * sol._dxs[2]
    upper = zc > 0.5 * zmax
    mats = np.stack([np.where(upper, a, b) for a, b in zip(SEIS_UP, SEIS_LO)], axis=3)
    u0 = torch.zeros(sol.state_shape, dtype=dtype, device=dev)
    u0[:, :, :, CK_EVOLVED:] = torch.from_numpy(mats).to(dev, dtype)
    amp = np.zeros((1, N_VARS_3D_HET))
    amp[0, 2] = 1.0
    src = PointSources(sol, [[0.5, 0.5, 0.75 * zmax]], amp, wavelet=ricker(SEIS_F0))
    rx = np.asarray([0.3, 0.4, 0.6, 0.7])
    rec = torch.as_tensor(np.stack([rx, np.full_like(rx, 0.5), np.full_like(rx, 0.95 * zmax)],
                                   -1), dtype=dtype, device=dev)
    probe = TracerAdvector(sol, lambda v: v[:, :3])
    dts = (float(sol.cfl_dt(u0, cfl=SEIS_CFL)), float(sol.cfl_dt(u0)))
    return sol, CudaADERDG(sol), u0, src, rec, probe, dts, zmax


def forced_run(torch, src, step_fn, probe, rec, u, t, dt, n: int):
    """``n`` Strang-split forced steps (``PointSources.step`` around
    ``step_fn``), the receivers sampled after each, as the example's scan
    body; ``t`` a 0-d tensor of the state's dtype on its device.  Returns
    ``(u, t, seismogram [n, receivers, n_vars])``, all on the device."""
    seis = []
    for _ in range(n):
        u = src.step(u, t, dt, step_fn)
        t = t + dt
        seis.append(probe.sample(u, rec))
    return u, t, torch.stack(seis)


def seismic_gates(torch, label: str, u, u0, seis, t: float, dt: float, zmax: float,
                  arrival: bool):
    """The example's checks (``:118-155``): finite, the materials bitwise
    frozen, the mirror symmetry of v_z and v_x across the source axis below
    ``SEIS_SYM`` of the seismogram's largest value, and, once t has passed
    the kinematic P arrival at the nearest receiver, the measured arrival
    (the first step whose largest value there passes 1 % of its peak)
    within ``SEIS_ARRIVAL`` of it.  They read the seismogram's velocity
    rows, the ``[n_steps, n_receivers, 3]`` the example's comment gives it
    (``:113``): its code keeps all 12 sampled rows, whose materials (λ = 2
    at the receivers) then set the 1 % threshold wherever the wave at the
    receivers stays under ~200, so that its arrival reads as the first step.
    Those readings are printed beside.  Fails on a miss (the arrival only
    where ``arrival`` says it must apply)."""
    import numpy as np

    s = seis.double().cpu().numpy()
    finite = bool(torch.isfinite(u).all()) and bool(np.isfinite(s).all())
    frozen = torch.equal(u[:, :, :, CK_EVOLVED:], u0[:, :, :, CK_EVOLVED:])
    cp_up = math.sqrt((SEIS_UP[1] + 2 * SEIS_UP[2]) / SEIS_UP[0])
    t_expect = math.hypot(0.1, 0.95 * zmax - 0.75 * zmax) / cp_up + 0.35 / SEIS_F0
    readings = {}
    for rows, x in (("velocity rows", s[..., :3]), ("all 12 rows, as the example's code", s)):
        v_mag = np.abs(x[:, 1, :]).max(axis=-1)
        readings[rows] = {
            "vz": float(np.abs(x[:, 1, 2] - x[:, 2, 2]).max()),
            "vx": float(np.abs(x[:, 1, 0] + x[:, 2, 0]).max()),
            "scale": max(float(np.abs(x).max()), 1e-30),
            "t_arrive": (int(np.argmax(v_mag > 0.01 * v_mag.max())) + 1) * dt,
        }
    applies = t > t_expect
    say(f"[seis gates] {label}: t = {t!r} after {s.shape[0]} steps; finite {finite}; "
        f"max|wave| {u[:, :, :, :CK_EVOLVED].abs().amax().item()!r}; "
        f"materials bitwise frozen {frozen}; t_expect = {t_expect!r} (the arrival gate "
        f"{'applies' if applies else 'does not apply yet'})")
    for rows, r in readings.items():
        say(f"[seis gates]   {rows}: mirror symmetry |vz diff| {r['vz']!r}, |vx sum| "
            f"{r['vx']!r} of field max {r['scale']!r} (gate {SEIS_SYM} of it); P arrival at "
            f"the nearest receiver t = {r['t_arrive']!r}, |diff| "
            f"{abs(r['t_arrive'] - t_expect) / t_expect!r} of t_expect (gate {SEIS_ARRIVAL})")
    r = readings["velocity rows"]
    if not (finite and frozen):
        fail(f"seismic {label}: the state is not finite or its materials moved")
    if not (r["vz"] < SEIS_SYM * r["scale"] and r["vx"] < SEIS_SYM * r["scale"]):
        fail(f"seismic {label}: the field is not mirror-symmetric across the source axis")
    if applies != arrival:
        fail(f"seismic {label}: t = {t} and t_expect = {t_expect}: the arrival gate should "
             f"{'' if arrival else 'not '}apply here")
    if applies and not abs(r["t_arrive"] - t_expect) < SEIS_ARRIVAL * t_expect:
        fail(f"seismic {label}: the P wave arrived at {r['t_arrive']}, expected {t_expect}")


def seismic_path(torch, dev, card) -> list[dict]:
    """The layered seismic form of the main path; returns the kernel JSON
    line of K2 a (at ``(63, 63, 36)``)."""
    import warnings

    import numpy as np

    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.elastic import N_VARS_3D_HET

    name = "aderdg_ck_predictor_volume_sponge"
    E, V = CK_EVOLVED, N_VARS_3D_HET

    def rel_check(label, got, ref):
        """``got`` against ``ref`` within ``SEIS_F64_RTOL`` of max(1,
        max|ref|); fails on a miss."""
        err = max_err(torch, got, ref)
        limit = SEIS_F64_RTOL * max(1.0, ref.abs().max().item())
        ok = err <= limit
        say(f"[seis parity] {label}: max_abs_err {err:.3e} limit {limit:.3e} (1e-12 of "
            f"max(1, max|plain|)) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"seismic {label} disagrees with its plain version")
        return err

    # ---------------------------------------- float64 at the example's CPU grid
    grid = SEIS_GRIDS[0]
    sol, cu, u0, src, rec, probe, (dt, dt_ex), zmax = seismic_setup(
        torch, dev, grid, torch.float64)
    if cu.kernels != (name, "aderdg_face_flux_walls", "aderdg_surface_update_walls"):
        fail(f"the seismic solver's kernels are {cu.kernels}")
    noise = np.random.default_rng(19).standard_normal(u0[:, :, :, :E].shape)
    u = u0.clone()
    u[:, :, :, :E] += SEIS_NOISE * torch.from_numpy(noise).to(u)
    say(f"[seis] {grid} f64: dt = cfl_dt(initial state, cfl={SEIS_CFL}) = {dt!r} (the "
        f"example's {dt_ex!r}); sponge {SEIS_SPONGE}, max σ "
        f"{float(sol.source_fn.sponge.sigma.max())!r}; kernels {cu.kernels}")
    for step_dt in (dt, dt_ex):
        new_k, faces_k, _ = cu.predictor_volume(u, step_dt)
        new_p, faces_p, _ = sol.predictor_volume(u, step_dt)
        torch.cuda.synchronize()
        rel_check(f"{name} (new) f64 {grid}, dt {step_dt!r}", new_k, new_p)
        rel_check(f"{name} (faces) f64 {grid}, dt {step_dt!r}", faces_k, faces_p)
        if not torch.equal(new_k[:, :, :, E:], u[:, :, :, E:]):
            fail("K2 a moved the material rows")
    walls_parity(torch, sol, cu, u, dt, "seismic (K2 a, free surface)", E,
                 [(0, E), (E, V - E)])
    t0 = torch.zeros((), dtype=torch.float64, device=dev)
    uk, _, sk = forced_run(torch, src, cu.step, probe, rec, u, t0, dt, SEIS_F64_STEPS)
    up, _, sp = forced_run(torch, src, sol.step, probe, rec, u, t0, dt, SEIS_F64_STEPS)
    rel_check(f"{SEIS_F64_STEPS} forced steps, kernel path vs plain (state) f64 {grid}", uk, up)
    rel_check(f"{SEIS_F64_STEPS} forced steps, kernel path vs plain (seismogram) f64 {grid}",
              sk, sp)
    cu.reset_launches()
    u1, t1, s1 = forced_run(torch, src, cu.step, probe, rec, u0, t0, dt, SEIS_STEPS[0])
    torch.cuda.synchronize()
    if cu.launches != {k: SEIS_STEPS[0] for k in cu.kernels}:
        fail(f"seismic {grid} launches {cu.launches}")
    seismic_gates(torch, f"{grid} f64, {SEIS_STEPS[0]} steps (the example's t)", u1, u0, s1,
                  float(t1), dt, zmax, arrival=False)
    u2, t2, s2 = forced_run(torch, src, cu.step, probe, rec, u1, t1, dt,
                            SEIS_ARRIVAL_STEPS[0] - SEIS_STEPS[0])
    seismic_gates(torch, f"{grid} f64, on to {SEIS_ARRIVAL_STEPS[0]} steps", u2, u0,
                  torch.cat([s1, s2]), float(t2), dt, zmax, arrival=True)
    del sol, cu, u0, u, new_k, faces_k, new_p, faces_p, uk, up, u1, u2

    # ---------------------------------------- float32 at the example's chip grid
    grid = SEIS_GRIDS[1]
    f32 = torch.float32
    sol, cu, u0, src, rec, probe, (dt, dt_ex), zmax = seismic_setup(torch, dev, grid, f32)
    t0 = torch.zeros((), dtype=f32, device=dev)
    ncell = math.prod(grid)
    say(f"[seis] {grid} f32: dt = cfl_dt(initial state, cfl={SEIS_CFL}) = {dt!r} (the "
        f"example's {dt_ex!r}); {ncell} cells, state {u0.nbytes} B; {SEIS_STEPS[1]} steps, "
        f"then to {SEIS_ARRIVAL_STEPS[1]}")
    cu.reset_launches()
    u400, t400, s400 = forced_run(torch, src, cu.step, probe, rec, u0, t0, dt, SEIS_STEPS[1])
    torch.cuda.synchronize()
    launches = dict(cu.launches)
    say(f"[seis main] {SEIS_STEPS[1]} forced steps of {grid} f32 through CudaADERDG: "
        f"launches {launches}")
    if launches != {k: SEIS_STEPS[1] for k in cu.kernels}:
        fail(f"seismic main path launches {launches}, expected 3 a step")
    seismic_gates(torch, f"{grid} f32, {SEIS_STEPS[1]} steps (the example's t)", u400, u0,
                  s400, float(t400), dt, zmax, arrival=False)
    u800, t800, s800 = forced_run(torch, src, cu.step, probe, rec, u400, t400, dt,
                                  SEIS_ARRIVAL_STEPS[1] - SEIS_STEPS[1])
    seismic_gates(torch, f"{grid} f32, on to {SEIS_ARRIVAL_STEPS[1]} steps", u800, u0,
                  torch.cat([s400, s800]), float(t800), dt, zmax, arrival=True)
    del u800, s800
    again, _, s_again = forced_run(torch, src, cu.step, probe, rec, u0, t0, dt, SEIS_STEPS[1])
    if not (torch.equal(again, u400) and torch.equal(s_again, s400)):
        fail("two seismic runs from the same state differ")
    say(f"[seis main] two {SEIS_STEPS[1]}-step runs: state and seismogram bitwise equal")
    del again, s_again
    # Kernel against plain on the step-800 field with seeded noise on the
    # wave rows in every cell.  By then the forced field has not reached the
    # sponge and its spike at the source sets max|plain| over the grid, so
    # the sponge's cells are held to a limit from their own max as well, and
    # the sourceless K2 on the same input must miss that limit.
    bare_sol = copy.copy(sol)
    bare_sol.source_fn = None
    bare = CudaADERDG(bare_sol)
    gen = torch.Generator(device=dev).manual_seed(29)
    un = u400.clone()
    un[:, :, :, :E] += SEIS_NOISE * torch.randn(un[:, :, :, :E].shape, generator=gen,
                                                device=dev, dtype=f32)
    in_sponge = torch.from_numpy(sol.source_fn.sponge.sigma > 0).to(dev)  # [*grid]
    say(f"[seis parity] {grid}: the sponge's cells {int(in_sponge.sum())} of {ncell}; noise "
        f"{SEIS_NOISE} x N(0, 1) on the wave rows of the step-{SEIS_STEPS[1]} field")

    def held(label, got, ref, bare_out, n_steps):
        """The evolved rows of ``got`` against ``ref`` over every cell and
        over the sponge's cells alone, each within ``n_steps`` x
        ``F32_ULPS`` f32 spacings of its own max|ref|; ``bare_out`` (the
        sourceless kernel's, from the same input) must miss the sponge
        cells' limit.  Fails on a miss; returns the error over every cell."""
        got, ref, bare_out = (x.narrow(3, 0, E) for x in (got, ref, bare_out))
        diff = (got.double() - ref.double()).abs()
        bare_diff = (bare_out.double() - ref.double()).abs()
        out = None
        for where, m in (("every cell", None), ("the sponge's cells", in_sponge)):
            pick = (lambda x: x) if m is None else (lambda x: torch.where(m, x, 0))  # noqa: E731
            e = pick(diff).amax().item()
            limit = n_steps * F32_ULPS * 2.0**-23 * pick(ref.abs()).amax().item()
            say(f"[seis parity] {label}, evolved rows over {where}: max_abs_err {e:.3e} limit "
                f"{limit:.3e} ({n_steps} x {F32_ULPS} f32 spacings of max|plain| there) "
                f"{'ok' if e <= limit else 'FAIL'}")
            if not e <= limit:
                fail(f"seismic {label} disagrees with its plain version over {where}")
            out = e if out is None else out
        b = pick(bare_diff).amax().item()
        say(f"[seis parity] {label}: the sourceless K2's max_abs_err over the sponge's cells "
            f"{b:.3e} ({b / limit:.1f}x the limit; must miss it)")
        if not b > limit:
            fail(f"seismic {label}: the check cannot tell the sponge from none")
        return out

    new_k, faces_k, _ = cu.predictor_volume(un, dt)
    new_p, faces_p, _ = sol.predictor_volume(un, dt)
    new_b, faces_b, _ = bare.predictor_volume(un, dt)
    torch.cuda.synchronize()
    err = max(held(f"{name} (new) f32 {grid}", new_k, new_p, new_b, 1),
              held(f"{name} (faces) f32 {grid}", faces_k, faces_p, faces_b, 1))
    mat_err = max_err(torch, faces_k.narrow(3, E, V - E), faces_p.narrow(3, E, V - E))
    mat_limit = f32_bound(torch, faces_p.narrow(3, E, V - E))
    mat_new = torch.equal(new_k[:, :, :, E:], un[:, :, :, E:])
    say(f"[seis parity] {name} f32 {grid}, material rows: new bitwise the input's {mat_new}; "
        f"faces max_abs_err {mat_err:.3e} limit {mat_limit:.3e} ({F32_ULPS} f32 spacings)")
    if not (mat_new and mat_err <= mat_limit):
        fail(f"K2 a's material rows disagree with its plain version at {grid}")
    del new_k, new_p, new_b, faces_k, faces_p, faces_b

    uk, _, sk = forced_run(torch, src, cu.step, probe, rec, un, t400, dt, SEIS_PLAIN_STEPS)
    up, _, sp = forced_run(torch, src, sol.step, probe, rec, un, t400, dt, SEIS_PLAIN_STEPS)
    ub = forced_run(torch, src, bare.step, probe, rec, un, t400, dt, SEIS_PLAIN_STEPS)[0]
    held(f"{SEIS_PLAIN_STEPS} forced steps from step {SEIS_STEPS[1]}, kernel path vs plain "
         f"path, f32 {grid}", uk, up, ub, SEIS_PLAIN_STEPS)
    seis_err = max_err(torch, sk, sp)
    seis_bound = SEIS_PLAIN_STEPS * f32_bound(torch, sp)
    plain_frozen = torch.equal(up[:, :, :, E:], u0[:, :, :, E:])
    say(f"[seis main] {SEIS_PLAIN_STEPS} forced steps, kernel path vs plain path: seismogram "
        f"max_abs_err {seis_err:.3e} limit {seis_bound:.3e} ({SEIS_PLAIN_STEPS} x {F32_ULPS} "
        f"f32 spacings of max|plain|); plain path's materials frozen {plain_frozen}")
    if not (seis_err <= seis_bound and plain_frozen):
        fail("the seismic main path disagrees with the plain path")
    del uk, up, ub, un

    # ------------------------------------------------ times
    k2a_ms = event_ms(torch, lambda: cu.predictor_volume(u400, dt), 20)
    k2_ms = event_ms(torch, lambda: bare.predictor_volume(u400, dt), 20)
    plain_ms = event_ms(torch, lambda: sol.predictor_volume(u400, dt), 3)
    _, faces, _ = cu.predictor_volume(u400, dt)
    fhat, fwall = cu.face_flux(faces)
    new = u400.clone()
    pair_ms = (event_ms(torch, lambda: cu.face_flux(faces), 20),
               event_ms(torch, lambda: cu.surface_update(new, fhat, dt, fwall), 20))
    inject_ms = event_ms(torch, lambda: src.inject(u400, t400, 0.5 * dt), 20)
    sample_ms = event_ms(torch, lambda: probe.sample(u400, rec), 20)
    say(f"[seis time] {grid} f32 (CUDA events): {name} {k2a_ms!r} ms, the sourceless K2 "
        f"aderdg_ck_predictor_volume on the same grid and state {k2_ms!r} ms "
        f"({k2a_ms / k2_ms:.3f}x), plain predictor_volume {plain_ms!r} ms; walled face pair "
        f"aderdg_face_flux_walls {pair_ms[0]!r} ms + aderdg_surface_update_walls "
        f"{pair_ms[1]!r} ms; PointSources.inject (half step) {inject_ms!r} ms; "
        f"TracerAdvector.sample (4 receivers) {sample_ms!r} ms ({card})")
    del fhat, fwall, new, faces
    forced = lambda n: forced_run(torch, src, cu.step, probe, rec, u400, t400, dt, n)  # noqa: E731
    win = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        forced(50)
        torch.cuda.synchronize()
        win.append(1e3 * (time.perf_counter() - t1) / 50)
    step_win = [1e3 * w for w in windows(torch, cu, u400, dt, steps=50)]
    plain_win = [1e3 * w for w in windows(torch, sol, u400, dt, steps=2, n_windows=1)]
    say(f"[seis time] {grid} forced step + sample (host clock, 3 windows of 50): ms per "
        f"window {win!r}, median {statistics.median(win)!r}; CudaADERDG.step alone "
        f"{step_win!r}, median {statistics.median(step_win)!r}; plain ADERDGSolver.step "
        f"{plain_win!r} ({card})")
    idle, busy, wall = idle_share(torch, lambda: forced(20))
    say(f"[seis idle] {grid} 20 forced steps + samples under torch.profiler: device busy "
        f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    forced(20)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    say(f"[seis mem] {grid} 20 forced steps: peak {peak} B allocated ({base} B before: the "
        f"state at the example's time, σ, the seismogram), state {u0.nbytes} B")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            forced(1)
            syncs = [w for w in caught if "synchroniz" in str(w.message)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    say(f"[seis main] host synchronisations in one forced step + sample (torch.cuda."
        f"set_sync_debug_mode('warn')): {len(syncs)}"
        + "".join(f"; {w.message}" for w in syncs[:3]))

    state_bytes, itemsize = u400.nbytes, u400.element_size()
    face_bytes = math.prod(sol.face_shape) * itemsize
    n_bytes = ck_bytes(state_bytes, face_bytes) + ncell * itemsize  # σ, one value a cell
    n_ops = ck_predictor_ops(ORDER, ncell) + ck_sponge_ops(ORDER, ncell)
    bnd = kernel_report(cu, name, f32, f"(CK + sponge, elastic, free surface) {grid} f32",
                        k2a_ms, n_bytes, n_ops, card)
    kernel_report(bare, "aderdg_ck_predictor_volume", f32,
                  f"(sourceless, same grid and state) {grid} f32", k2_ms,
                  ck_bytes(state_bytes, face_bytes), ck_predictor_ops(ORDER, ncell), card)
    return [kernel_line(name, "exahype_tpu/models/aderdg_pallas.py:416", launches[name], err,
                        k2a_ms, plain_ms, bnd)]


def point_source_setup(torch, dev, grid, dtype):
    """``examples/seismic_point_source.py --ck`` (``:36-66``) at ``grid``:
    the 2-D CK elastic solver (ρ, λ, μ = 1, 2, 1) in the traction-free box,
    ``CudaADERDG`` over it, the state at rest, the vertical Ricker point
    force at (0.5, 0.5), the receivers at y = 0.3 (in the state's dtype),
    the probe of (v_x, v_y), and the example's dt (``cfl_dt`` of a state of
    ones at the default cfl) as a Python float."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import ADERDGSolver
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.elastic import elastic, elastic_free_surface
    from exahype_tpu_torch.models.point_source import PointSources, ricker
    from exahype_tpu_torch.models.tracers import TracerAdvector

    flux, eig = elastic(*EL2_MATERIALS)
    reflect, reflect_flux = elastic_free_surface()
    sol = ADERDGSolver(2, ORDER, 5, grid, flux, eig, dx=1.0 / grid[0], device=dev, dtype=dtype,
                       boundary="reflective", reflect_fn=reflect, reflect_flux_fn=reflect_flux,
                       predictor_mode="ck")
    amp = np.zeros((1, 5))
    amp[0, 1] = 1.0
    src = PointSources(sol, [[0.5, 0.5]], amp, wavelet=ricker(EL2_F0))
    rx = np.asarray([0.3, 0.4, 0.6, 0.7])
    rec = torch.as_tensor(np.stack([rx, np.full_like(rx, 0.3)], -1), dtype=dtype, device=dev)
    probe = TracerAdvector(sol, lambda v: v[:, :2])
    u0 = torch.zeros(sol.state_shape, dtype=dtype, device=dev)
    dt = float(sol.cfl_dt(torch.ones_like(u0)))
    return sol, CudaADERDG(sol), u0, src, rec, probe, dt


def point_source_gates(label: str, seis, t: float, dt: float, gate: bool) -> dict:
    """The example's checks (``:79-100``) on a seismogram ``[n, 4, 2]``:
    the mirror symmetry of v_y (even) and v_x (odd) across the source axis
    below ``EL2_SYM`` of the field's maximum, and, once t has passed the
    kinematic P arrival at the nearest receiver, the measured arrival (the
    first step whose largest value there passes 1 % of its peak) within
    ``EL2_ARRIVAL`` of it.  With ``gate`` a miss fails (and the arrival gate
    must apply); without, the figures are a reading."""
    import numpy as np

    s = seis.double().cpu().numpy()
    scale = max(float(np.abs(s).max()), 1e-30)
    vy = float(np.abs(s[:, 1, 1] - s[:, 2, 1]).max()) / scale
    vx = float(np.abs(s[:, 1, 0] + s[:, 2, 0]).max()) / scale
    cp = math.sqrt((EL2_MATERIALS[1] + 2 * EL2_MATERIALS[2]) / EL2_MATERIALS[0])
    t_expect = math.hypot(0.1, 0.2) / cp + 0.35 / EL2_F0
    v_mag = np.abs(s[:, 1, :]).max(axis=-1)
    t_arrive = (int(np.argmax(v_mag > 0.01 * v_mag.max())) + 1) * dt
    applies = t > t_expect
    finite = bool(np.isfinite(s).all())
    say(f"[{'ps gates' if gate else 'ps reading'}] {label}: t = {t!r} after {s.shape[0]} steps, "
        f"finite {finite}; mirror symmetry |vy diff| {vy!r}, |vx sum| {vx!r} of the field max "
        f"{scale!r} (gate {EL2_SYM}); t_expect = {t_expect!r}, the arrival gate "
        f"{'applies' if applies else 'does not apply'}: P arrival at the nearest receiver "
        f"t = {t_arrive!r}, |diff| {abs(t_arrive - t_expect) / t_expect!r} of t_expect (gate "
        f"{EL2_ARRIVAL})")
    if gate:
        if not (finite and vy < EL2_SYM and vx < EL2_SYM):
            fail(f"point source {label}: not finite or not mirror-symmetric")
        if not (applies and abs(t_arrive - t_expect) < EL2_ARRIVAL * t_expect):
            fail(f"point source {label}: the P arrival gate does not apply or misses "
                 f"({t_arrive} against {t_expect})")
    return {"vy": vy, "vx": vx, "t_arrive": t_arrive, "t_expect": t_expect}


def elastic_k2b_path(torch, dev, card) -> list[dict]:
    """K2 b, the homogeneous elasticity on the CK kernels: the 3-D
    ``elastic3d`` step at order 2 and ``examples/seismic_point_source.py
    --ck`` in 2-D; returns the kernel JSON lines of their six kernels."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import ADERDGSolver
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.elastic import elastic3d, plane_p_wave_3d

    lines = []
    f32, f64 = torch.float32, torch.float64

    # ------------------------------------------------ 3-D elastic3d at p2
    def make3(grid, dtype):
        sol = ADERDGSolver(3, EL3_ORDER, 9, grid, *elastic3d(*EL3_MATERIALS), dx=1.0 / grid[0],
                           device=dev, dtype=dtype, predictor_mode="ck")
        return sol, CudaADERDG(sol)

    def noisy(sol, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return EL_NOISE * torch.randn(sol.state_shape, generator=gen, device=dev, dtype=dtype)

    errs3 = {}
    for grid in EL3_CUTS:
        sol, cu = make3(grid, f64)
        u = noisy(sol, f64, seed=grid[2])
        for name, e in parity_2d(torch, sol, cu, u, 0.5 * float(sol.cfl_dt(u)),
                                 "elastic3d p2, periodic", "k2b").items():
            errs3[name] = max(errs3.get(name, 0.0), e)
    grid = EL3_GRID
    sol, cu = make3(grid, f32)
    ncell = math.prod(grid)
    X = np.broadcast_to(np.squeeze(sol.nodes_meshgrid()[0], 3),
                        sol.state_shape[:3] + sol.state_shape[4:])
    rho, lam, mu = EL3_MATERIALS
    exact = lambda t: torch.from_numpy(np.ascontiguousarray(np.moveaxis(  # noqa: E731
        plane_p_wave_3d(X, t, rho=rho, lam=lam, mu=mu), -1, 3)))
    u0 = exact(0.0).to(dev, f32)
    dt = float(sol.cfl_dt(u0, cfl=EL3_CFL))
    say(f"[k2b] elastic3d p2 {grid} f32: {sol.dofs()} DOF, state {u0.nbytes} B; dt = "
        f"cfl_dt(plane P wave, cfl={EL3_CFL}) = {dt!r}; kernels {cu.kernels}")
    for name, e in parity_2d(torch, sol, cu, noisy(sol, f32, seed=7), dt,
                             "elastic3d p2, seeded noise", "k2b").items():
        errs3[name] = max(errs3.get(name, 0.0), e)
    cu.reset_launches()
    u = cu.run(u0, EL3_STEPS, dt)
    torch.cuda.synchronize()
    launches3 = dict(cu.launches)
    if launches3 != {k: EL3_STEPS for k in cu.kernels}:
        fail(f"elastic3d p2 launched {launches3} in {EL3_STEPS} steps, expected 3 a step")
    again = cu.run(u0, EL3_STEPS, dt)
    plain = sol.run(u0, EL3_STEPS, dt)
    torch.cuda.synchronize()
    want = exact(EL3_STEPS * dt).to(dev, torch.float64)
    err_plain, limit = max_err(torch, u, plain), EL3_STEPS * f32_bound(torch, plain)
    err_exact = max_err(torch, u, want) / want.abs().max().item()
    err_exact_plain = max_err(torch, plain, want) / want.abs().max().item()
    say(f"[k2b main] {EL3_STEPS} steps of the plane P wave, {grid} f32, through CudaADERDG: "
        f"launches {launches3}; two runs bitwise equal {torch.equal(u, again)}; vs the plain "
        f"path max_abs_err {err_plain:.3e} limit {limit:.3e} ({EL3_STEPS} x {F32_ULPS} f32 "
        f"spacings); vs the exact wave (relative to its max) {err_exact:.3e}, the plain path's "
        f"{err_exact_plain:.3e} (gate {EL3_EXACT})")
    if not (torch.equal(u, again) and err_plain <= limit and err_exact < EL3_EXACT):
        fail("the elastic3d p2 step is not repeatable, or misses the plain path or the wave")
    del again, plain, want
    growth = {}
    seeded = u0 + EL3_SEED * noisy(sol, f32, seed=11)
    for cfl in (None, 0.3, EL3_CFL):
        c_dt = float(sol.cfl_dt(u0, cfl=cfl))
        uu = cu.run(seeded, EL3_CFL_STEPS, c_dt)
        growth[cfl] = uu.abs().max().item() / seeded.abs().max().item()
    say(f"[k2b reading] elastic3d p2 {grid} f32, {EL3_CFL_STEPS} steps of the plane P wave "
        f"with seeded noise of {EL3_SEED * EL_NOISE} (a plane wave alone excites no "
        f"transverse mode): "
        f"max|q| / max|q0| at cfl {min(0.4, 1.5 / (EL3_ORDER + 2))} (the default) "
        f"{growth[None]!r}, at 0.3 {growth[0.3]!r}, at {EL3_CFL} {growth[EL3_CFL]!r}")
    if not growth[EL3_CFL] < 1.01:
        fail(f"the elastic3d p2 step at cfl {EL3_CFL} grows")
    new, faces, _ = cu.predictor_volume(u, dt)
    fhat, _ = cu.face_flux(faces)
    times3 = {
        cu.kernels[0]: (event_ms(torch, lambda: cu.predictor_volume(u, dt), 20),
                        event_ms(torch, lambda: sol.predictor_volume(u, dt), 3)),
        cu.kernels[1]: (event_ms(torch, lambda: cu.face_flux(faces), 20),
                        event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3)),
        cu.kernels[2]: (event_ms(torch, lambda: cu.surface_update(new, fhat, dt), 20),
                        event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt), 3)),
    }
    win = [1e3 * w for w in windows(torch, cu, u, dt, steps=20)]
    plain_win = [1e3 * w for w in windows(torch, sol, u, dt, steps=2, n_windows=1)]
    idle, busy, wall = idle_share(torch, lambda: cu.run(u, 10, dt))
    say(f"[k2b time] elastic3d p2 {grid} f32: step ms per window {win!r}, median "
        f"{statistics.median(win)!r} ms, {sol.dofs() / statistics.median(win) * 1e3!r} "
        f"DOF-updates/s; plain step {plain_win!r} ms; kernels (CUDA events) " + ", ".join(
            f"{k} {v[0]!r} ms (plain {v[1]!r} ms)" for k, v in times3.items()) + f" ({card})")
    say(f"[k2b idle] elastic3d p2 {grid}, 10 steps under torch.profiler: device busy {busy!r} "
        f"ms of wall {wall!r} ms; idle share {idle!r} ({card})")
    itemsize = u.element_size()
    face_bytes = faces.nbytes
    kw = dict(dim=3, nvar=9)
    work3 = {
        cu.kernels[0]: (ck_bytes(u.nbytes, face_bytes),
                        ck_predictor_ops(EL3_ORDER, ncell, evolved=9, flux_ops=EL3_FLUX_OPS,
                                         **kw)),
        cu.kernels[1]: (face_flux_bytes(EL3_ORDER, ncell, itemsize, rows=9, **kw),
                        face_flux_ops(EL3_ORDER, ncell, eig_ops=0, **kw)),
        cu.kernels[2]: (surface_update_bytes(EL3_ORDER, ncell, itemsize, rows=9),
                        surface_update_ops(EL3_ORDER, ncell, **kw)),
    }
    for name, (n_bytes, n_ops) in work3.items():
        bnd = kernel_report(cu, name, f32, f"(K2 b, elastic3d p2, periodic) {grid} f32",
                            times3[name][0], n_bytes, n_ops, card)
        replaces = ("exahype_tpu/models/aderdg_pallas.py:358" if name == cu.kernels[0]
                    else "exahype_tpu/models/aderdg_pallas.py:156")
        lines.append(kernel_line(name, replaces, launches3[name], errs3[name], *times3[name],
                                 bnd))
    del sol, cu, u, u0, uu, seeded, new, faces, fhat
    torch.cuda.empty_cache()

    # ---------------------------- 2-D: examples/seismic_point_source.py --ck
    errs2 = {}
    for grid in EL2_CUTS:
        for walled in (True, False):
            sol, cu, u0, *_ = point_source_setup(torch, dev, grid, f64)
            if not walled:
                sol = ADERDGSolver(2, ORDER, 5, grid, sol.flux_fn, sol.max_eigenvalue_fn,
                                   dx=1.0 / grid[0], device=dev, dtype=f64, predictor_mode="ck")
                cu = CudaADERDG(sol)
            u = noisy(sol, f64, seed=grid[0] + walled)
            for name, e in parity_2d(torch, sol, cu, u, 0.5 * float(sol.cfl_dt(u)),
                                     "free surface" if walled else "periodic", "k2b").items():
                errs2[name] = max(errs2.get(name, 0.0), e)
    sol, cu, u0, src, rec, probe, dt = point_source_setup(torch, dev, EL2_GRID, f32)
    t0 = torch.zeros((), dtype=f32, device=dev)
    say(f"[ps] examples/seismic_point_source.py --ck at {EL2_GRID} f32 (odd: the source at "
        f"x = 0.5 is a cell centre): dt = cfl_dt(ones) = {dt!r}; {EL2_STEPS} forced steps to "
        f"t = {EL2_STEPS * dt!r}; kernels {cu.kernels}")
    cu.reset_launches()
    # The first EL2_REPEAT_STEPS apart: the repeat runs them again.
    u1, t, s1 = forced_run(torch, src, cu.step, probe, rec, u0, t0, dt, EL2_REPEAT_STEPS)
    u, t, s2 = forced_run(torch, src, cu.step, probe, rec, u1, t, dt,
                          EL2_STEPS - EL2_REPEAT_STEPS)
    seis = torch.cat([s1, s2])
    torch.cuda.synchronize()
    launches2 = dict(cu.launches)
    if launches2 != {k: EL2_STEPS for k in cu.kernels}:
        fail(f"the point-source run launched {launches2} in {EL2_STEPS} steps")
    point_source_gates(f"{EL2_GRID} f32, {EL2_STEPS} steps", seis, float(t), dt, gate=True)
    u_b, _, s_b = forced_run(torch, src, cu.step, probe, rec, u0, t0, dt, EL2_REPEAT_STEPS)
    if not (torch.equal(u_b, u1) and torch.equal(s_b, s1)):
        fail("two point-source runs from rest differ")
    n_cmp = EL2_PLAIN_STEPS
    uk, _, sk = forced_run(torch, src, cu.step, probe, rec, u, t, dt, n_cmp)
    up, _, sp = forced_run(torch, src, sol.step, probe, rec, u, t, dt, n_cmp)
    e_state, l_state = max_err(torch, uk, up), n_cmp * f32_bound(torch, up)
    e_seis, l_seis = max_err(torch, sk, sp), n_cmp * f32_bound(torch, sp)
    say(f"[ps main] {EL2_GRID}: launches {launches2} (3 a step); the first {EL2_REPEAT_STEPS} "
        f"steps run twice bitwise equal; "
        f"{n_cmp} forced steps on from step {EL2_STEPS}, kernel path vs plain path: state "
        f"max_abs_err {e_state:.3e} limit {l_state:.3e}, seismogram {e_seis:.3e} limit "
        f"{l_seis:.3e} ({n_cmp} x {F32_ULPS} f32 spacings)")
    if not (e_state <= l_state and e_seis <= l_seis):
        fail("the point-source kernel path disagrees with the plain path")
    del u_b, s_b, u1, s1, s2, uk, up, sk, sp
    grid_ex, steps_ex = EL2_EXAMPLE
    sol_e, cu_e, u0_e, src_e, rec_e, probe_e, dt_e = point_source_setup(torch, dev, grid_ex, f32)
    _, t_e, s_e = forced_run(torch, src_e, cu_e.step, probe_e, rec_e, u0_e,
                             torch.zeros((), dtype=f32, device=dev), dt_e, steps_ex)
    point_source_gates(f"the example as written, {grid_ex} f32, {steps_ex} steps (an even grid: "
                       "the source on a cell face; its t before t_expect)", s_e, float(t_e), dt_e,
                       gate=False)
    del sol_e, cu_e, u0_e, s_e

    grid = EL2_TIME_GRID
    sol, cu, u0, src, rec, probe, dt = point_source_setup(torch, dev, grid, f32)
    ncell = math.prod(grid)
    t0 = torch.zeros((), dtype=f32, device=dev)
    u, t, _ = forced_run(torch, src, cu.step, probe, rec, u0, t0, dt, EL2_TIME_WARMUP)
    un = u + noisy(sol, f32, seed=3)
    for name, e in parity_2d(torch, sol, cu, un, dt, "free surface, seeded noise",
                             "k2b").items():
        errs2[name] = max(errs2.get(name, 0.0), e)
    del un
    forced = lambda n: forced_run(torch, src, cu.step, probe, rec, u, t, dt, n)  # noqa: E731
    win = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        forced(20)
        torch.cuda.synchronize()
        win.append(1e3 * (time.perf_counter() - t1) / 20)
    step_win = [1e3 * w for w in windows(torch, cu, u, dt, steps=20)]
    plain_win = [1e3 * w for w in windows(torch, sol, u, dt, steps=2, n_windows=1)]
    idle, busy, wall = idle_share(torch, lambda: forced(20))
    new, faces, _ = cu.predictor_volume(u, dt)
    fhat, fwall = cu.face_flux(faces)
    walls = cu.wall_fluxes(fwall)
    times2 = {
        cu.kernels[0]: (event_ms(torch, lambda: cu.predictor_volume(u, dt), 20),
                        event_ms(torch, lambda: sol.predictor_volume(u, dt), 3)),
        cu.kernels[1]: (event_ms(torch, lambda: cu.face_flux(faces), 20),
                        event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3)),
        cu.kernels[2]: (event_ms(torch, lambda: cu.surface_update(new, fhat, dt, fwall), 20),
                        event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt, walls),
                                 3)),
    }
    say(f"[ps time] {grid} f32, {sol.dofs()} DOF, state {u.nbytes} B: forced step + sample "
        f"(host clock, 3 windows of 20) ms {win!r}, median {statistics.median(win)!r}; "
        f"CudaADERDG.step alone {step_win!r}, median {statistics.median(step_win)!r} ms, "
        f"{sol.dofs() / statistics.median(step_win) * 1e3!r} DOF-updates/s; plain step "
        f"{plain_win!r} ms; kernels (CUDA events) " + ", ".join(
            f"{k} {v[0]!r} ms (plain {v[1]!r} ms)" for k, v in times2.items()) + f" ({card})")
    say(f"[ps idle] {grid}, 20 forced steps + samples under torch.profiler: device busy "
        f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")
    itemsize = u.element_size()
    kw = dict(dim=2, nvar=5)
    side = cu.walls["size"] * itemsize
    low = cu.walls["size"] // sol.n_vars  # low-wall solves
    work2 = {
        cu.kernels[0]: (ck_bytes(u.nbytes, faces.nbytes),
                        ck_predictor_ops(ORDER, ncell, evolved=5, flux_ops=EL2_FLUX_OPS, **kw)),
        cu.kernels[1]: (face_flux_bytes(ORDER, ncell, itemsize, rows=5, **kw) + side,
                        face_flux_ops(ORDER, ncell, eig_ops=0, **kw) + low * 6 * 5),
        cu.kernels[2]: (surface_update_bytes(ORDER, ncell, itemsize, dim=2, rows=5) + side,
                        surface_update_ops(ORDER, ncell, **kw)),
    }
    for name, (n_bytes, n_ops) in work2.items():
        bnd = kernel_report(cu, name, f32, f"(K2 b, 2-D elastic p3, free surface) {grid} f32",
                            times2[name][0], n_bytes, n_ops, card)
        replaces = ("exahype_tpu/models/aderdg_pallas.py:358" if name == cu.kernels[0]
                    else "exahype_tpu/models/aderdg_pallas.py:156")
        lines.append(kernel_line(f"{name} (Elastic2D)", replaces, launches2[name], errs2[name],
                                 *times2[name], bnd, source="exahype_tpu_torch/csrc/aderdg_2d.cu"))
    del sol, cu, u, u0, new, faces, fhat, fwall, walls
    return lines


def topo_setup(torch, dev, grid, dtype, height=None):
    """``examples/seismic_topography.py``'s run (``:61-101``) at ``grid``:
    the curvilinear CK elastic solver over the hill of ``height`` (None: the
    Cartesian 2-D ``elastic`` solver of the flat-limit gate), ``CudaADERDG``
    over it, the state at rest (densitized in float64, then cast), the
    Ricker force, the receivers and the probe of the first two rows."""
    import numpy as np

    from exahype_tpu_torch.models import curvilinear as cv
    from exahype_tpu_torch.models.aderdg import ADERDGSolver
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.elastic import elastic
    from exahype_tpu_torch.models.point_source import PointSources, ricker
    from exahype_tpu_torch.models.tracers import TracerAdvector

    pair = elastic(*TOPO_MATERIALS)
    if height is None:
        sol = ADERDGSolver(2, ORDER, 5, grid, *pair, dx=1.0 / grid[0], device=dev, dtype=dtype,
                           predictor_mode="ck")
        u0 = torch.zeros(sol.state_shape, dtype=dtype, device=dev)
    else:
        sol = ADERDGSolver(2, ORDER, 10, grid, *cv.curvilinear_physics(*pair, dim=2, n_wave=5),
                           dx=1.0 / grid[0], device=dev, dtype=dtype, predictor_mode="ck",
                           ck_material_slots=cv.curvilinear_material_slots(5, 2),
                           dissipation_mask=cv.curvilinear_dissipation_mask(5, 2))
        metric, _ = cv.metric_fields(sol, cv.hill_mapping(height))
        zeros = torch.zeros(sol.state_shape[:2] + (5,) + sol.state_shape[3:],
                            dtype=torch.float64, device=dev)
        u0 = cv.densitize(zeros, metric, 2).to(dtype).contiguous()
    amp = np.zeros((1, sol.n_vars))
    amp[0, 1] = 1.0  # the vertical force
    src = PointSources(sol, [list(TOPO_SOURCE)], amp, wavelet=ricker(TOPO_F0))
    rx = np.asarray(TOPO_RX)
    rec = torch.as_tensor(np.stack([rx, np.full_like(rx, TOPO_RX_Y)], -1), dtype=dtype,
                          device=dev)
    probe = TracerAdvector(sol, lambda v: v[:, :2])
    return sol, CudaADERDG(sol), u0, src, rec, probe


def parity_k2b1(torch, sol, cu, u, dt, label: str) -> dict:
    """The K2 b.1 kernels against their plain versions on ``u``
    (:func:`stages_2d`), each tensor's moving rows and its frozen rows
    (materials or metric; their face fluxes zero) against bounds of their
    own largest values: float64 within ``F64_ATOL`` of max(1, that value),
    float32 within ``F32_ULPS`` spacings of it; a step keeps the frozen rows
    of ``u``.  ``[k2b1 parity]`` lines; fails on a disagreement; returns the
    largest error of each kernel."""
    rows = cu._flux_rows
    # The var axis of each compared tensor: the state's, the face tensor's,
    # F̂'s, a face row's (fwall[d], face fluxes[d]).
    axes = {"new": sol.dim, "faces": 3, "fhat": 2}
    f64 = u.dtype == torch.float64
    errs = {}
    for name, what, got, ref in stages_2d(torch, sol, cu, u, dt):
        va = axes.get(what, sol.dim - 1)
        parts = [(got, ref)] if what == "fhat" else [
            (got.narrow(va, 0, rows), ref.narrow(va, 0, rows)),
            (got.narrow(va, rows, sol.n_vars - rows), ref.narrow(va, rows, sol.n_vars - rows))]
        err = limit = 0.0
        ok = True
        for g, r in parts:
            e = max_err(torch, g, r)
            lim = F64_ATOL * max(1.0, r.abs().max().item()) if f64 else f32_bound(torch, r)
            ok &= e <= lim
            err, limit = max(err, e), max(limit, lim)
        say(f"[k2b1 parity] {label}: {name} ({what}) {str(u.dtype)[6:]} {sol.grid_shape}: "
            f"max_abs_err {err:.3e} limit {limit:.3e} (moving and frozen rows each against "
            f"their own largest value) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the K2 b.1 {name} ({what}) disagrees with its plain version ({label})")
        errs[name] = max(errs.get(name, 0.0), err)
    va = sol.var_axis
    out = cu.step(u, dt)
    if not torch.equal(out.narrow(va, rows, sol.n_vars - rows),
                       u.narrow(va, rows, sol.n_vars - rows)):
        fail(f"the K2 b.1 step moved its frozen rows ({label})")
    return errs


def k2b1_state(torch, sol, dev, dtype, first: int, seed: int):
    """Seeded normal wave rows and materials from slot ``first`` constant in
    each cell (ρ in [1, 2), λ in [1, 3), μ in [0.5, 1.5)), made in float64
    on the device from a seeded generator and cast."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(sol.state_shape, generator=gen, device=dev, dtype=torch.float64)
    for k, (lo, span) in enumerate(((1.0, 1.0), (1.0, 2.0), (0.5, 1.0))):
        q.select(sol.var_axis, first + k)[...] = lo + span * torch.rand(
            tuple(sol.grid_shape), generator=gen, device=dev, dtype=torch.float64)
    return q.to(dtype).contiguous()


def topo_noisy(torch, sol, u0, seed: int):
    """``u0`` (the state at rest over the metric) with seeded normal wave
    rows densitized by its J."""
    gen = torch.Generator(device=u0.device).manual_seed(seed)
    noise = torch.randn(u0[:, :, :5].shape, generator=gen, device=u0.device, dtype=u0.dtype)
    return torch.cat([noise * u0[:, :, 5:6], u0[:, :, 5:]], dim=2).contiguous()


def topo_arrivals(torch, seis, dt: float, height: float) -> list:
    """For each receiver: ``(r/c_p, the time of the seismogram's maximum,
    the time its magnitude first passes 1 % of that)``, r the physical
    distance from the source through the hill's mapping."""
    import numpy as np

    from exahype_tpu_torch.models.curvilinear import hill_mapping

    mp = hill_mapping(height)
    x = lambda p: np.asarray([float(c) for c in mp(torch.tensor(p, dtype=torch.float64))])  # noqa: E731
    cp = math.sqrt((TOPO_MATERIALS[1] + 2 * TOPO_MATERIALS[2]) / TOPO_MATERIALS[0])
    s = seis[..., :2].double().abs().amax(dim=-1).cpu().numpy()  # [n, receivers]
    out = []
    for r, rx in enumerate(TOPO_RX):
        dist = float(np.linalg.norm(x((rx, TOPO_RX_Y)) - x(TOPO_SOURCE)))
        k = int(np.argmax(s[:, r]))
        onset = int(np.argmax(s[:, r] > 0.01 * s[k, r]))
        out.append((dist / cp, (k + 1) * dt, (onset + 1) * dt))
    return out


def k2b1_path(torch, dev, card) -> list[dict]:
    """K2 b.1, frozen slots and the dissipation mask on the CK node kernel:
    ``examples/seismic_topography.py`` on the card (the curvilinear
    elasticity), the 12-variable heterogeneous elasticity at order 2 and the
    8-variable 2-D one; returns the kernel JSON lines of their kernels."""
    import numpy as np

    from exahype_tpu_torch.models import elastic as el
    from exahype_tpu_torch.models.aderdg import ADERDGSolver
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

    f32, f64 = torch.float32, torch.float64
    gib = 2.0**-30
    errs = {}
    sections, t_sec = {}, time.perf_counter()

    def keep(system, found):
        for name, e in found.items():
            errs[(system, name)] = max(errs.get((system, name), 0.0), e)

    def het3(grid, dtype):
        sol = ADERDGSolver(3, EL3_ORDER, 12, grid, *el.elastic3d_heterogeneous(),
                           dx=1.0 / grid[0], device=dev, dtype=dtype, predictor_mode="ck",
                           ck_material_slots=el.MATERIAL_SLOTS,
                           dissipation_mask=el.DISSIPATION_MASK)
        return sol, CudaADERDG(sol)

    def het2(grid, dtype, walled=False):
        hooks = {}
        if walled:
            reflect, reflect_flux = el.elastic_free_surface_het()
            hooks = dict(boundary="reflective", reflect_fn=reflect, reflect_flux_fn=reflect_flux)
        sol = ADERDGSolver(2, ORDER, 8, grid, *el.elastic_heterogeneous(), dx=1.0 / grid[0],
                           device=dev, dtype=dtype, predictor_mode="ck",
                           ck_material_slots=el.MATERIAL_SLOTS_HET,
                           dissipation_mask=el.DISSIPATION_MASK_HET, **hooks)
        return sol, CudaADERDG(sol)

    # ------------------------------------------ 1. float64 at the cut grids
    for grid in K2B1_CUTS:
        sol, cu, u0, *_ = topo_setup(torch, dev, grid, f64, TOPO_HEIGHT)
        u = topo_noisy(torch, sol, u0, seed=grid[1])
        keep("curvilinear", parity_k2b1(torch, sol, cu, u, 0.5 * float(sol.cfl_dt(u)),
                                        "curvilinear, hill, periodic"))
        for walled in (False, True):
            sol, cu = het2(grid, f64, walled)
            u = k2b1_state(torch, sol, dev, f64, 5, seed=grid[0] + walled)
            keep("het2d_walls" if walled else "het2d", parity_k2b1(
                torch, sol, cu, u, 0.5 * float(sol.cfl_dt(u)),
                "2-D heterogeneous, " + ("free surface" if walled else "periodic")))
    for grid in HET3_CUTS:
        sol, cu = het3(grid, f64)
        u = k2b1_state(torch, sol, dev, f64, 9, seed=sum(grid))
        keep("het3d", parity_k2b1(torch, sol, cu, u, 0.5 * float(sol.cfl_dt(u, cfl=HET3_CFL)),
                                  "3-D heterogeneous p2, periodic"))
    del sol, cu, u, u0

    # ----------------------- 2. examples/seismic_topography.py past the arrival
    sections["parity at the cut grids"] = time.perf_counter() - t_sec
    t_sec = time.perf_counter()
    grid, dt = TOPO_GRID, TOPO_DT
    t0 = torch.zeros((), dtype=f32, device=dev)
    runs = {}
    for label, height in (("flat", 0.0), ("Cartesian", None), ("hill", TOPO_HEIGHT)):
        sol, cu, u0, src, rec, probe = topo_setup(torch, dev, grid, f32, height)
        cu.reset_launches()
        t1 = time.perf_counter()
        # The first TOPO_REPEAT_STEPS apart: the repeat runs them again.
        u1, t, s1 = forced_run(torch, src, cu.step, probe, rec, u0, t0, dt, TOPO_REPEAT_STEPS)
        u, t, s2 = forced_run(torch, src, cu.step, probe, rec, u1, t, dt,
                              TOPO_STEPS - TOPO_REPEAT_STEPS)
        torch.cuda.synchronize()
        runs[label] = dict(sol=sol, cu=cu, u0=u0, src=src, rec=rec, probe=probe, u=u, t=t,
                           u_repeat=u1, seis=torch.cat([s1, s2]), launches=dict(cu.launches),
                           secs=time.perf_counter() - t1)
    hill = runs["hill"]
    cu, sol = hill["cu"], hill["sol"]
    launches_topo = hill["launches"]
    say(f"[topo] examples/seismic_topography.py at {grid} f32, dt = {dt}, {TOPO_STEPS} forced "
        f"steps to t = {float(hill['t'])!r} (the example: {TOPO_EXAMPLE_STEPS}); kernels "
        f"{cu.kernels}; seconds per run (host clock, the receivers sampled each step): " +
        ", ".join(f"{k} {v['secs']:.2f}" for k, v in runs.items()))
    for label, r in runs.items():
        if r["launches"] != {k: TOPO_STEPS for k in r["cu"].kernels}:
            fail(f"the {label} topography run launched {r['launches']} in {TOPO_STEPS} steps")
    s_flat, s_cart, s_hill = (runs[k]["seis"][..., :2].double() for k in
                              ("flat", "Cartesian", "hill"))
    scale = max(s_cart.abs().max().item(), 1e-30)
    flat_err = (s_flat - s_cart).abs().max().item()
    effect = (s_hill - s_flat).abs().max().item()
    frozen = torch.equal(hill["u"][:, :, 5:], hill["u0"][:, :, 5:])
    finite = all(bool(torch.isfinite(r["u"]).all()) for r in runs.values())
    say(f"[topo gates] finite {finite}; flat limit vs the Cartesian CK step: max seismogram "
        f"diff {flat_err!r} of the field max {scale!r} (gate {TOPO_FLAT} of it); metric slots "
        f"frozen {frozen}; topography effect {effect!r} ({effect / scale!r} of the field max, "
        f"gate > {TOPO_EFFECT})")
    if not (finite and flat_err < TOPO_FLAT * scale and frozen and effect > TOPO_EFFECT * scale):
        fail("the topography run misses the example's gates")
    t_end = float(hill["t"])
    for label, height in (("flat", 0.0), ("hill", TOPO_HEIGHT)):
        arr = topo_arrivals(torch, runs[label]["seis"], dt, height)
        say(f"[topo arrival] {label}: per receiver x = {TOPO_RX}: P travel time r/c_p, the "
            "seismogram's maximum at t, its 1 % onset at t: " + "; ".join(
                f"{a!r}, {b!r}, {c!r}" for a, b, c in arr) + f" (run ends at t = {t_end!r}; "
            f"gate: maximum after r/c_p + 1/(2 f0), before the end)")
        if not all(a + 0.5 / TOPO_F0 < b < t_end - dt and c > a for a, b, c in arr):
            fail(f"the {label} topography run's maximum does not come after the P arrival")
    again = forced_run(torch, hill["src"], cu.step, hill["probe"], hill["rec"], hill["u0"], t0,
                       dt, TOPO_REPEAT_STEPS)
    if not (torch.equal(again[0], hill["u_repeat"])
            and torch.equal(again[2], hill["seis"][:TOPO_REPEAT_STEPS])):
        fail("two topography runs from rest differ")
    del again
    n_cmp = TOPO_PLAIN_STEPS
    args = (hill["probe"], hill["rec"], hill["u"], hill["t"], dt, n_cmp)
    uk, _, sk = forced_run(torch, hill["src"], cu.step, *args)
    up, _, sp = forced_run(torch, hill["src"], sol.step, *args)
    e_state, l_state = max_err(torch, uk[:, :, :5], up[:, :, :5]), n_cmp * f32_bound(
        torch, up[:, :, :5])
    e_seis, l_seis = max_err(torch, sk[..., :2], sp[..., :2]), n_cmp * f32_bound(
        torch, sp[..., :2])
    say(f"[topo main] {grid}: launches {launches_topo} (3 a step); the first "
        f"{TOPO_REPEAT_STEPS} steps run twice bitwise equal; "
        f"{n_cmp} forced steps on from step {TOPO_STEPS}, kernel path vs plain path: wave rows "
        f"max_abs_err {e_state:.3e} limit {l_state:.3e}, seismogram {e_seis:.3e} limit "
        f"{l_seis:.3e} ({n_cmp} x {F32_ULPS} f32 spacings); metric rows equal "
        f"{torch.equal(uk[:, :, 5:], up[:, :, 5:])}")
    if not (e_state <= l_state and e_seis <= l_seis and torch.equal(uk[:, :, 5:], up[:, :, 5:])):
        fail("the topography kernel path disagrees with the plain path")
    del uk, up, sk, sp
    # The example's own run is the first TOPO_EXAMPLE_STEPS steps of these.
    ex = {label: r["seis"][:TOPO_EXAMPLE_STEPS, :, :2].double() for label, r in runs.items()}
    ex_scale = max(ex["Cartesian"].abs().max().item(), 1e-30)
    say(f"[topo reading] the example as written, its {TOPO_EXAMPLE_STEPS} steps (the runs' "
        f"first; t = {TOPO_EXAMPLE_STEPS * dt!r}, before the P wave leaves the source): field max "
        f"{ex_scale!r} (the source's amplitude is 1); flat vs Cartesian "
        f"{(ex['flat'] - ex['Cartesian']).abs().max().item()!r}; topography effect "
        f"{(ex['hill'] - ex['flat']).abs().max().item()!r}")
    del runs, ex, hill

    # --------------------------- 3. the curvilinear step at (1024, 1024) f32
    sections["the topography run"] = time.perf_counter() - t_sec
    t_sec = time.perf_counter()
    grid = K2B1_TIME_GRID
    ncell = math.prod(grid)
    sol, cu, u0, src, rec, probe = topo_setup(torch, dev, grid, f32, TOPO_HEIGHT)
    un = topo_noisy(torch, sol, u0, seed=3)
    dt = 0.5 * float(sol.cfl_dt(un))
    say(f"[topo] {grid} f32: {sol.dofs()} DOF, state {u0.nbytes} B; full-width parity on seeded "
        f"noise at dt = {dt!r}")
    keep("curvilinear", parity_k2b1(torch, sol, cu, un, dt, "curvilinear, hill, seeded noise"))
    del un
    dt = TOPO_DT
    u, t, _ = forced_run(torch, src, cu.step, probe, rec, u0, t0, dt, K2B1_TIME_WARMUP)
    forced = lambda n: forced_run(torch, src, cu.step, probe, rec, u, t, dt, n)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    win = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        forced(20)
        torch.cuda.synchronize()
        win.append(1e3 * (time.perf_counter() - t1) / 20)
    peak = torch.cuda.max_memory_allocated()
    step_win = [1e3 * w for w in windows(torch, cu, u, dt, steps=20)]
    plain_win = [1e3 * w for w in windows(torch, sol, u, dt, steps=2, n_windows=1)]
    idle, busy, wall = idle_share(torch, lambda: forced(20))
    new, faces, _ = cu.predictor_volume(u, dt)
    fhat, _ = cu.face_flux(faces)
    times = {
        "curvilinear": {
            cu.kernels[0]: (event_ms(torch, lambda: cu.predictor_volume(u, dt), 20),
                            event_ms(torch, lambda: sol.predictor_volume(u, dt), 3)),
            cu.kernels[1]: (event_ms(torch, lambda: cu.face_flux(faces), 20),
                            event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3)),
            cu.kernels[2]: (event_ms(torch, lambda: cu.surface_update(new, fhat, dt), 20),
                            event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt),
                                     3)),
        }
    }
    say(f"[topo time] {grid} f32: forced step + sample (host clock, 3 windows of 20) ms {win!r}, "
        f"median {statistics.median(win)!r}; CudaADERDG.step alone {step_win!r}, median "
        f"{statistics.median(step_win)!r} ms, "
        f"{evolved_dofs(sol, 5) / statistics.median(step_win) * 1e3!r} evolved-DOF-updates/s "
        f"({evolved_dofs(sol, 5)} evolved DOF per step); plain step "
        f"{plain_win!r} ms; kernels (CUDA events) " + ", ".join(
            f"{k} {v[0]!r} ms (plain {v[1]!r} ms)" for k, v in times["curvilinear"].items())
        + f" ({card})")
    say(f"[topo idle] {grid}, 20 forced steps + samples under torch.profiler: device busy "
        f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r}; peak memory of the forced steps "
        f"{peak * gib:.4f} GiB allocated ({card})")
    itemsize = u.element_size()
    kw2 = dict(dim=2)
    work = {
        "curvilinear": {
            cu.kernels[0]: (ck_bytes(u.nbytes, ck_face_bytes(ORDER, ncell, itemsize, read=CURV_READ,
                                                             rows=5, **kw2)),
                            ck_predictor_ops(ORDER, ncell, nvar=10, evolved=5,
                                             flux_ops=CURV_FLUX_OPS, **kw2)),
            cu.kernels[1]: (face_flux_bytes(ORDER, ncell, itemsize, nvar=CURV_READ, rows=5,
                                            **kw2),
                            face_flux_ops(ORDER, ncell, nvar=5, eig_ops=CURV_EIG_OPS,
                                          masked=True, **kw2)),
            cu.kernels[2]: (surface_update_bytes(ORDER, ncell, itemsize, rows=5, **kw2),
                            surface_update_ops(ORDER, ncell, nvar=5, **kw2)),
        }
    }
    kernels = {"curvilinear": (cu, launches_topo, "(K2 b.1, curvilinear elastic p3, periodic)",
                               grid)}
    del sol, u0, u, new, faces, fhat, src, probe
    torch.cuda.empty_cache()

    # ------------------------------ 4. the 3-D heterogeneous elasticity at p2
    sections["the curvilinear step at full width"] = time.perf_counter() - t_sec
    t_sec = time.perf_counter()
    grid = HET3_GRID
    ncell = math.prod(grid)
    sol, cu3 = het3(grid, f32)
    q, _ = el.two_layer_state(sol)
    u0 = torch.from_numpy(q).to(dev, f32).contiguous()
    dt = float(sol.cfl_dt(u0, cfl=HET3_CFL))
    say(f"[het3] elastic3d_het p2 {grid} f32: {sol.dofs()} DOF, state {u0.nbytes} B; two-layer "
        f"materials and the plane P wave; dt = cfl_dt(cfl={HET3_CFL}) = {dt!r}; kernels "
        f"{cu3.kernels}")
    keep("het3d", parity_k2b1(torch, sol, cu3, k2b1_state(torch, sol, dev, f32, 9, seed=7),
                              dt, "3-D heterogeneous p2, seeded noise"))
    cu3.reset_launches()
    u = cu3.run(u0, HET3_STEPS, dt)
    torch.cuda.synchronize()
    launches3 = dict(cu3.launches)
    again = cu3.run(u0, HET3_STEPS, dt)
    plain = sol.run(u0, HET3_STEPS, dt)
    torch.cuda.synchronize()
    err = max_err(torch, u[:, :, :, :9], plain[:, :, :, :9])
    limit = HET3_STEPS * f32_bound(torch, plain[:, :, :, :9])
    frozen = torch.equal(u[:, :, :, 9:], u0[:, :, :, 9:])
    say(f"[het3 main] {HET3_STEPS} steps, {grid} f32, through CudaADERDG: launches {launches3}; "
        f"two runs bitwise equal {torch.equal(u, again)}; the wave rows vs the plain path "
        f"max_abs_err {err:.3e} limit {limit:.3e} ({HET3_STEPS} x {F32_ULPS} f32 spacings of "
        f"their largest value); materials frozen {frozen}; finite "
        f"{bool(torch.isfinite(u).all())}")
    if launches3 != {k: HET3_STEPS for k in cu3.kernels}:
        fail(f"the heterogeneous p2 step launched {launches3} in {HET3_STEPS} steps")
    if not (torch.equal(u, again) and err <= limit and frozen and torch.isfinite(u).all()):
        fail("the heterogeneous p2 step is not repeatable, misses the plain path or moved its "
             "materials")
    del again, plain
    new, faces, _ = cu3.predictor_volume(u, dt)
    fhat, _ = cu3.face_flux(faces)
    times["het3d"] = {
        cu3.kernels[0]: (event_ms(torch, lambda: cu3.predictor_volume(u, dt), 20),
                         event_ms(torch, lambda: sol.predictor_volume(u, dt), 3)),
        cu3.kernels[1]: (event_ms(torch, lambda: cu3.face_flux(faces), 20),
                         event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3)),
        cu3.kernels[2]: (event_ms(torch, lambda: cu3.surface_update(new, fhat, dt), 20),
                         event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt), 3)),
    }
    win = [1e3 * w for w in windows(torch, cu3, u, dt, steps=10)]
    plain_win = [1e3 * w for w in windows(torch, sol, u, dt, steps=2, n_windows=1)]
    idle, busy, wall = idle_share(torch, lambda: cu3.run(u, 10, dt))
    say(f"[het3 time] {grid} f32: step ms per window {win!r}, median {statistics.median(win)!r} "
        f"ms, {evolved_dofs(sol, 9) / statistics.median(win) * 1e3!r} evolved-DOF-updates/s "
        f"({evolved_dofs(sol, 9)} evolved DOF per step); plain step {plain_win!r} ms; kernels "
        f"(CUDA events) " + ", ".join(
            f"{k} {v[0]!r} ms (plain {v[1]!r} ms)" for k, v in times["het3d"].items())
        + f"; 10 steps under torch.profiler: device busy {busy!r} ms of wall {wall!r} ms, idle "
        f"share {idle!r} ({card})")
    itemsize = u.element_size()
    kw3 = dict(dim=3)
    work["het3d"] = {
        cu3.kernels[0]: (ck_bytes(u.nbytes, ck_face_bytes(EL3_ORDER, ncell, itemsize, read=12,
                                                          rows=9, **kw3)),
                         ck_predictor_ops(EL3_ORDER, ncell, nvar=12, evolved=9, **kw3)),
        cu3.kernels[1]: (face_flux_bytes(EL3_ORDER, ncell, itemsize, nvar=12, rows=9, **kw3),
                         face_flux_ops(EL3_ORDER, ncell, nvar=9, eig_ops=ELASTIC_EIG_OPS,
                                       masked=True, **kw3)),
        cu3.kernels[2]: (surface_update_bytes(EL3_ORDER, ncell, itemsize, rows=9, **kw3),
                         surface_update_ops(EL3_ORDER, ncell, nvar=9, **kw3)),
    }
    kernels["het3d"] = (cu3, launches3, "(K2 b.1, elastic3d_het p2, periodic)", grid)
    del sol, u0, u, new, faces, fhat
    torch.cuda.empty_cache()

    # ------------------------------ 5. the 2-D heterogeneous elasticity at p3
    sections["the 3-D heterogeneous step"] = time.perf_counter() - t_sec
    t_sec = time.perf_counter()
    grid = K2B1_TIME_GRID
    ncell = math.prod(grid)
    rho, lam, mu = HET2_MATERIALS
    sol, cu2 = het2(grid, f32)
    hom = ADERDGSolver(2, ORDER, 5, grid, *el.elastic(rho, lam, mu), dx=1.0 / grid[0],
                       device=dev, dtype=f32, predictor_mode="ck")
    cu_hom = CudaADERDG(hom)
    va = 2
    no_var = hom.state_shape[:va] + hom.state_shape[va + 1:]
    X, Y = (np.broadcast_to(np.squeeze(c, va), no_var) for c in hom.nodes_meshgrid())
    wave = np.moveaxis(el.plane_p_wave(X, Y, 0.0, rho=rho, lam=lam, mu=mu), -1, va)
    mats = np.stack([np.full(X.shape, v) for v in HET2_MATERIALS], axis=va)
    u0 = torch.from_numpy(np.concatenate([wave, mats], axis=va)).to(dev, f32).contiguous()
    w0 = torch.from_numpy(np.ascontiguousarray(wave)).to(dev, f32)
    dt = float(hom.cfl_dt(w0))
    keep("het2d", parity_k2b1(torch, sol, cu2, k2b1_state(torch, sol, dev, f32, 5, seed=9),
                              dt, "2-D heterogeneous, seeded noise"))
    cu2.reset_launches()
    u = cu2.run(u0, HET2_STEPS, dt)
    w = cu_hom.run(w0, HET2_STEPS, dt)
    torch.cuda.synchronize()
    launches2 = dict(cu2.launches)
    err, limit = max_err(torch, u[:, :, :5], w), HET2_STEPS * f32_bound(torch, w)
    frozen = torch.equal(u[:, :, 5:], u0[:, :, 5:])
    say(f"[het2 main] tests/test_ck.py:139's property at {grid} f32: constant materials "
        f"{HET2_MATERIALS}, the plane P wave, {HET2_STEPS} steps of dt = {dt!r} through "
        f"CudaADERDG (launches {launches2}) against K2 b's homogeneous instance "
        f"{cu_hom.kernels[0]}: wave rows max_abs_err {err:.3e} limit {limit:.3e} "
        f"({HET2_STEPS} x {F32_ULPS} f32 spacings); materials frozen {frozen}")
    if launches2 != {k: HET2_STEPS for k in cu2.kernels}:
        fail(f"the 2-D heterogeneous step launched {launches2} in {HET2_STEPS} steps")
    if not (err <= limit and frozen):
        fail("the 2-D heterogeneous step with constant materials misses the homogeneous one")
    del w, w0, cu_hom, hom
    new, faces, _ = cu2.predictor_volume(u, dt)
    fhat, _ = cu2.face_flux(faces)
    times["het2d"] = {
        cu2.kernels[0]: (event_ms(torch, lambda: cu2.predictor_volume(u, dt), 20),
                         event_ms(torch, lambda: sol.predictor_volume(u, dt), 3)),
        cu2.kernels[1]: (event_ms(torch, lambda: cu2.face_flux(faces), 20),
                         event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3)),
        cu2.kernels[2]: (event_ms(torch, lambda: cu2.surface_update(new, fhat, dt), 20),
                         event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt), 3)),
    }
    win = [1e3 * w for w in windows(torch, cu2, u, dt, steps=10)]
    itemsize = u.element_size()
    work["het2d"] = {
        cu2.kernels[0]: (ck_bytes(u.nbytes, ck_face_bytes(ORDER, ncell, itemsize, read=8, rows=5,
                                                          **kw2)),
                         ck_predictor_ops(ORDER, ncell, nvar=8, evolved=5,
                                          flux_ops=HET2_FLUX_OPS, **kw2)),
        cu2.kernels[1]: (face_flux_bytes(ORDER, ncell, itemsize, nvar=8, rows=5, **kw2),
                         face_flux_ops(ORDER, ncell, nvar=5, eig_ops=ELASTIC_EIG_OPS,
                                       masked=True, **kw2)),
        cu2.kernels[2]: (surface_update_bytes(ORDER, ncell, itemsize, rows=5, **kw2),
                         surface_update_ops(ORDER, ncell, nvar=5, **kw2)),
    }
    kernels["het2d"] = (cu2, launches2, "(K2 b.1, 2-D elastic_het p3, periodic)", grid)
    del new, faces, fhat
    solw, cuw = het2(grid, f32, walled=True)
    keep("het2d_walls", parity_k2b1(torch, solw, cuw, k2b1_state(torch, solw, dev, f32, 5,
                                                                  seed=10),
                                    dt, "2-D heterogeneous, free surface, seeded noise"))
    cuw.reset_launches()
    uw = cuw.run(u0, HET2_STEPS, dt)
    torch.cuda.synchronize()
    launchesw = {k: v for k, v in cuw.launches.items() if k != cuw.kernels[0]}
    pw = solw.run(u0, HET2_STEPS, dt)
    err, limit = max_err(torch, uw[:, :, :5], pw[:, :, :5]), HET2_STEPS * f32_bound(
        torch, pw[:, :, :5])
    say(f"[het2 walls] {grid} f32, free surface on both axes, {HET2_STEPS} steps: launches "
        f"{dict(cuw.launches)}; wave rows vs the plain path max_abs_err {err:.3e} limit "
        f"{limit:.3e}; materials frozen {torch.equal(uw[:, :, 5:], u0[:, :, 5:])}")
    if not (err <= limit and torch.equal(uw[:, :, 5:], u0[:, :, 5:])
            and launchesw == {k: HET2_STEPS for k in cuw.kernels[1:]}):
        fail("the walled 2-D heterogeneous step misses the plain path or its launches")
    new, faces, _ = cuw.predictor_volume(uw, dt)
    fhat, fwall = cuw.face_flux(faces)
    walls = cuw.wall_fluxes(fwall)
    times["het2d_walls"] = {
        cuw.kernels[1]: (event_ms(torch, lambda: cuw.face_flux(faces), 20),
                         event_ms(torch, lambda: plain_face_flux(torch, solw, faces), 3)),
        cuw.kernels[2]: (event_ms(torch, lambda: cuw.surface_update(new, fhat, dt, fwall), 20),
                         event_ms(torch, lambda: plain_surface_update(solw, new, fhat, dt,
                                                                      walls), 3)),
    }
    wall_win = [1e3 * w for w in windows(torch, cuw, uw, dt, steps=10)]
    side = cuw.walls["size"] * itemsize
    low = cuw.walls["size"] // solw.n_vars  # low-wall solves
    work["het2d_walls"] = {
        cuw.kernels[1]: (face_flux_bytes(ORDER, ncell, itemsize, nvar=8, rows=5, **kw2) + side,
                         face_flux_ops(ORDER, ncell, nvar=5, eig_ops=ELASTIC_EIG_OPS,
                                       masked=True, **kw2) + low * 7 * 5),
        cuw.kernels[2]: (surface_update_bytes(ORDER, ncell, itemsize, rows=5, **kw2) + side,
                         surface_update_ops(ORDER, ncell, nvar=5, **kw2)),
    }
    kernels["het2d_walls"] = (cuw, launchesw, "(K2 b.1, 2-D elastic_het p3, free surface)",
                              grid)
    say(f"[het2 time] {grid} f32: step ms per window periodic {win!r} (median "
        f"{evolved_dofs(sol, 5) / statistics.median(win) * 1e3!r} evolved-DOF-updates/s, "
        f"{evolved_dofs(sol, 5)} evolved DOF per step), free surface "
        f"{wall_win!r}; kernels (CUDA events) " + ", ".join(
            f"{k} {v[0]!r} ms (plain {v[1]!r} ms)"
            for sysname in ("het2d", "het2d_walls") for k, v in times[sysname].items())
        + f" ({card})")
    del new, faces, fhat, fwall, walls, u, uw, pw, u0

    # ------------------------------------------------------- 6. the lines
    sections["the 2-D heterogeneous step"] = time.perf_counter() - t_sec
    say("[k2b1 time] seconds per section (host clock): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sections.items()))
    systems = {"curvilinear": "CurvilinearElastic", "het3d": "ElasticHetPhysics",
               "het2d": "ElasticHet2D", "het2d_walls": "ElasticHet2D"}
    lines = []
    for system, (kcu, launches, where, kgrid) in kernels.items():
        for name, (n_bytes, n_ops) in work[system].items():
            bnd = kernel_report(kcu, name, f32, f"{where} {kgrid} f32", times[system][name][0],
                                n_bytes, n_ops, card)
            replaces = ("exahype_tpu/models/aderdg_pallas.py:377"
                        if name.startswith("aderdg_ck_") else
                        "exahype_tpu/models/aderdg_pallas.py:156")
            source = ("exahype_tpu_torch/csrc/aderdg.cu" if system == "het3d"
                      else "exahype_tpu_torch/csrc/aderdg_2d.cu")
            if name.startswith("aderdg_ck_"):
                source = "exahype_tpu_torch/csrc/aderdg_ck_nodes.cuh"
            lines.append(kernel_line(f"{name} ({systems[system]})", replaces, launches[name],
                                     errs[(system, name)], *times[system][name], bnd,
                                     source=source))
    del kernels, cu, cu2, cu3, cuw, sol, solw
    torch.cuda.empty_cache()
    return lines


def fv_path(torch, dev, card, spec_printers) -> dict:
    """The FV form of the main path; returns K4's line of the kernel JSON."""
    from exahype_tpu_torch.models import euler
    from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
    from exahype_tpu_torch.parallel.grid import TpuPatchGrid
    from exahype_tpu_torch.parallel.solver import GridSolver

    for name, pr in spec_printers.items():
        say(f"[fv] K4 {name} spec: {pr.bytes_per_patch(torch.float32)} B of shared "
            f"memory per patch in f32; tiles {pr.tiles[torch.float32]} (f32) and "
            f"{pr.tiles[torch.float64]} (f64) patches per block")

    def solver(grid, dtype=torch.float32):
        kb = build_fv_rusanov_kernel(**FV_WIDTH, n_patches=math.prod(grid))
        return GridSolver(
            TpuPatchGrid(kb.config, grid), kb, dx=1.0 / (4 * grid[0]), cfl=FV_CFL,
            eigenvalue_fn=euler.wave_speed_fn(3), kernel_dt="lambda",
            device=dev, dtype=dtype,
        )

    # ------------------------------------------------ K4 vs plain
    big = FV_GRIDS[-1]
    k4_err = None
    for name, grid, dtype in (("fv", (2, 2, 2), torch.float64),
                              ("rusanov", (2, 2, 2), torch.float64),
                              ("fv", big, torch.float32)):
        fn = spec_printers[name].build()
        q = fv_state(torch, grid, dev, dtype)
        lam = 0.05  # λ = dt/dx, inside the CFL limit of this state (~0.19)
        got = fn(q.clone(), lam)
        by_ptr = fn(q.clone(), torch.tensor(lam, device=dev, dtype=dtype))
        ref = fn.plain(q.clone(), lam)
        torch.cuda.synchronize()
        err = max_err(torch, got, ref)
        f64 = dtype == torch.float64
        limit = F64_ATOL if f64 else f32_bound(torch, ref)
        ok = err <= limit and torch.equal(got, by_ptr) and fn.launches == 2
        say(f"[parity] K4 {name} spec {str(dtype)[6:]} {grid}: max_abs_err {err:.3e} "
            f"limit {limit:.3e} ({'atol' if f64 else f'{F32_ULPS} f32 spacings'}); "
            f"λ by pointer == by value: {torch.equal(got, by_ptr)}; "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K4 ({name} spec, {dtype}, {grid}) disagrees with its plain version")
        # The sentinel check: 1e30 in every state value outside the printer's
        # read set; the output on the write set must be the clean run's, bit
        # for bit, and every value outside the write set its input.
        pr = spec_printers[name]
        read, write = (spec_mask(torch, q, cells) for cells in (pr.read_cells, pr.write_cells))
        probed = q.clone()
        probed[~read] = SENTINEL
        out = fn(probed.clone(), lam)
        torch.cuda.synchronize()
        checks = {
            "write set equal to the clean run's": torch.equal(out[write], got[write]),
            "outside the write set unchanged": torch.equal(out[~write], probed[~write]),
            "clean run outside the write set unchanged": torch.equal(got[~write], q[~write]),
        }
        say(f"[parity] K4 {name} spec {str(dtype)[6:]} {grid} sentinel {SENTINEL:g} outside "
            f"the read set ({len(pr.read_cells)} of {read.numel()} values a patch read, "
            f"{len(pr.write_cells)} written): {checks}")
        if not all(checks.values()):
            fail(f"K4 ({name} spec, {dtype}, {grid}) reads or writes outside its sets")
        if grid == big:
            k4_err = err
        del q, got, by_ptr, ref, probed, out, read, write

    # ------------------------------------------------ main path, both sizes
    record = None
    for grid in FV_GRIDS:
        sv = solver(grid)
        u0 = fv_state(torch, grid, dev, torch.float32)
        n_patches = sv.grid.config.n_patches
        sv.kernel_fn.launches = 0
        u, t = sv.run(u0, STEPS)
        torch.cuda.synchronize()
        launches = sv.kernel_fn.launches
        say(f"[fv main] {STEPS} CFL steps of {grid} ({n_patches} patches) f32 "
            f"through GridSolver: K4 launches {launches}; t = {float(t)!r}")
        if launches != STEPS:
            fail(f"K4 launched {launches} times in {STEPS} FV main-path steps")
        if tuple(u.shape) != sv.grid.state_shape or not torch.isfinite(u).all():
            fail("FV main-path state is not finite or has the wrong shape")
        m0, m1 = interior_mass(torch, u0), interior_mass(torch, u)
        drift = ((m1 - m0).abs() / m0.abs()).max().item()
        say(f"[fv main] mass drift over {STEPS} steps (max rel over 5 vars): "
            f"{drift:.3e} limit {MASS_RTOL:.1e}")
        if not drift <= MASS_RTOL:
            fail("FV mass drift beyond its bound")
        again, _ = sv.run(u0, STEPS)
        if not torch.equal(u, again):
            fail("two FV runs from the same state differ")
        say("[fv main] two runs from the same state: bitwise equal")
        plain = copy.copy(sv)
        plain.kernel_fn = sv.kernel_fn.plain
        plain_u, _ = plain.run(u0, STEPS)
        run_err = max_err(torch, u, plain_u)
        run_bound = STEPS * f32_bound(torch, plain_u)
        say(f"[fv main] {STEPS}-step kernel path vs plain path: max_abs_err "
            f"{run_err:.3e} limit {run_bound:.3e}")
        if not run_err <= run_bound:
            fail("FV main path disagrees with the plain path")
        del again, plain_u, u

        # -------------------------------------------- times
        dofs = sv.dofs()
        steps = 20
        k_win = windows(torch, sv, u0, None, steps=steps)
        p_win = windows(torch, plain, u0, None, steps=3)
        for label, win in (("kernel path", k_win), ("plain path", p_win)):
            ms = [1e3 * w for w in win]
            say(f"[fv time] {grid} {label}: step ms per window {ms!r}; median "
                f"{statistics.median(ms)!r} ms, {dofs / statistics.median(win)!r} "
                f"DOF-updates/s ({dofs} DOF per step; {card})")
        q = u0.clone()
        lam = sv.compute_dt(q) / sv.dx
        parts = {
            "K4 kernel": event_ms(torch, lambda: sv.kernel_fn(q, lam), steps),
            "K4 plain": event_ms(torch, lambda: sv.kernel_fn.plain(q, lam), 3),
            "halo_fill": event_ms(torch, lambda: sv.grid.halo_fill(q), steps),
            "compute_dt": event_ms(torch, lambda: sv.compute_dt(q), steps),
        }
        say(f"[fv time] {grid} per call (CUDA events): " + ", ".join(
            f"{k} {v!r} ms" for k, v in parts.items()) + f" ({card})")
        for label, solv, n in (("kernel path", sv, steps), ("plain path", plain, 3)):
            idle, busy, wall = idle_share(torch, lambda: solv.run(u0, n))
            say(f"[fv idle] {grid} {label}, {n} steps under torch.profiler: device "
                f"busy {busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")
        needed = fv_bytes(n_patches, u0.element_size())
        moved = sv.kernel_fn.printer.moved_bytes(n_patches, u0.dtype)
        bnd = kernel_report(None, "spec_kernel (fv)", torch.float32, f"(FV) {grid} f32",
                            parts["K4 kernel"], needed, fv_ops(n_patches), card,
                            info=sv.kernel_fn.kernel_info(torch.float32))
        say(f"[bound] K4 fv {grid} f32: bound {bnd['bound_ms']!r} ms by "
            f"{bnd['bound_by']} ({needed} B needed, {fv_ops(n_patches)!r} flops); "
            f"kernel {parts['K4 kernel']!r} ms, moving {moved} B (the read set read and "
            f"the write set written: {1e3 * moved / PEAK_BYTES!r} ms at the memory rate; "
            f"the whole padded state read and written would be {2 * u0.nbytes} B) ({card})")
        if grid == big:
            record = {
                "name": "spec_kernel (fv Rusanov spec, generated)",
                "route": "cuda",
                "source": "exahype_tpu_torch/backends/cuda_backend.py",
                "replaces": "exahype_tpu/backends/pallas_backend.py:202",
                "launches": launches,
                "max_abs_err": k4_err,
                "ms": parts["K4 kernel"],
                "plain_ms": parts["K4 plain"],
                **bnd,
                "library_ms": None,  # no single PyTorch call computes it
            }
        del sv, plain, u0, q
        torch.cuda.empty_cache()
    return record


def aderdg_path(torch, dev, card) -> list[dict]:
    """The ADER-DG form of the main path; returns the kernel JSON lines of
    its three kernels and of the face stage (the pair of launches)."""
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

    flux, eig = euler_physics(3, n_real=5)

    def make(grid, dtype):
        sol = ADERDGSolver(3, ORDER, 5, grid, flux, eig, dx=DX,
                           device=dev, dtype=dtype)
        return sol, CudaADERDG(sol)

    sol, cu = make(GRID, torch.float32)
    u0 = bench_state(sol, torch, dev, torch.float32)
    dt = float(cu.cfl_dt(u0))  # once, at set-up
    say(f"[main] dt = cfl_dt(initial state) = {dt!r} (bench.py's 1e-4 "
        "exceeds the CFL limit)")

    # ------------------------------------------- 3. kernel vs plain
    errs = {}
    for grid, dtype in (((8, 4, 32), torch.float64), (GRID, torch.float32)):
        psol, pcu = make(grid, dtype)
        u = bench_state(psol, torch, dev, dtype)
        u_in = u.clone()
        new_k, faces_k, _ = pcu.predictor_volume(u, dt)
        new_p, faces_p, _ = psol.predictor_volume(u, dt)
        surf_k = pcu.face_surface(new_p.clone(), faces_p, dt)
        surf_p = psol.face_surface(new_p, faces_p, dt)
        fhat_k, fhat_p = pcu.face_flux(faces_p)[0], plain_face_flux(torch, psol, faces_p)
        upd_k = pcu.surface_update(new_p.clone(), fhat_p, dt)
        upd_p = plain_surface_update(psol, new_p, fhat_p, dt)
        step_k = pcu.step(u, dt)
        step_p = psol.step(u, dt)
        torch.cuda.synchronize()
        if not torch.equal(u, u_in):
            fail("the step modified its input")
        f64 = dtype == torch.float64
        rule = "atol" if f64 else f"{F32_ULPS} f32 spacings of max|plain|"
        for name, what, got, ref in (
            ("aderdg_predictor_volume", "new", new_k, new_p),
            ("aderdg_predictor_volume", "faces", faces_k, faces_p),
            ("face stage", "new", surf_k, surf_p),
            ("aderdg_face_flux", "fhat", fhat_k, fhat_p),
            ("aderdg_surface_update", "new", upd_k, upd_p),
            ("step", "new", step_k, step_p),
        ):
            err = max_err(torch, got, ref)
            limit = F64_ATOL if f64 else f32_bound(torch, ref)
            ok = err <= limit
            say(f"[parity] {name} ({what}) {str(dtype)[6:]} {grid}: "
                f"max_abs_err {err:.3e} limit {limit:.3e} ({rule}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} disagrees with its plain version ({dtype}, {grid})")
            if grid == GRID:
                errs[name] = max(errs.get(name, 0.0), err)
        if grid == GRID:
            # Both float32 paths against the float64 plain step.
            sol64, _ = make(GRID, torch.float64)
            ref64 = sol64.step(u.double(), dt)
            say(f"[parity] float32 step vs float64 plain step {grid}: kernel "
                f"{max_err(torch, step_k, ref64):.3e}, plain "
                f"{max_err(torch, step_p, ref64):.3e}")
            del sol64, ref64
        del psol, pcu, u, u_in, new_k, faces_k, new_p, faces_p, surf_k, surf_p
        del fhat_k, fhat_p, upd_k, upd_p, step_k, step_p, got, ref

    # --------------------------------------------------- 4. main path
    gib = 2.0**-30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cu.reset_launches()
    u = cu.run(u0, STEPS, dt)
    torch.cuda.synchronize()
    launches = dict(cu.launches)
    say(f"[mem] kernel path, {STEPS} steps: peak {torch.cuda.max_memory_allocated() * gib:.4f} "
        f"GiB allocated ({held * gib:.4f} GiB held before: initial state, "
        f"operators) ({card})")
    say(f"[main] {STEPS} steps of {GRID} f32 through CudaADERDG: launches "
        f"{launches}")
    for name, n in launches.items():
        if n != STEPS:
            fail(f"{name} launched {n} times in {STEPS} main-path steps")
    if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
        fail("main-path state is not finite or has the wrong shape")
    m0 = cu.total_mass(u0.double())
    m1 = cu.total_mass(u.double())
    drift = ((m1 - m0).abs() / m0.abs()).max().item()
    say(f"[main] mass drift over {STEPS} steps (max rel over 5 vars): "
        f"{drift:.3e} limit {MASS_RTOL:.1e}")
    if not drift <= MASS_RTOL:
        fail("mass drift beyond its bound")
    again = cu.run(u0, STEPS, dt)
    if not torch.equal(u, again):
        fail("two runs from the same state differ")
    say("[main] two runs from the same state: bitwise equal")
    del again
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    plain_u = sol.run(u0, STEPS, dt)
    torch.cuda.synchronize()
    say(f"[mem] plain path, {STEPS} steps: peak {torch.cuda.max_memory_allocated() * gib:.4f} "
        f"GiB allocated ({held * gib:.4f} GiB held before: initial state, "
        f"kernel-path result, operators) ({card})")
    run_err = max_err(torch, u, plain_u)
    run_bound = STEPS * f32_bound(torch, plain_u)
    say(f"[main] {STEPS}-step kernel path vs plain path: max_abs_err "
        f"{run_err:.3e} limit {run_bound:.3e}")
    if not run_err <= run_bound:
        fail("main path disagrees with the plain path")
    del plain_u

    # --------------------------------------------------------- 5. times
    dofs = cu.dofs()
    k_win = windows(torch, cu, u0, dt, steps=20)
    p_win = windows(torch, sol, u0, dt, steps=3)
    for label, win in (("kernel path", k_win), ("plain path", p_win)):
        ms = [1e3 * s for s in win]
        say(f"[time] {label}: step ms per window {ms!r}; "
            f"median {statistics.median(ms)!r} ms, "
            f"{dofs / statistics.median(win)!r} DOF-updates/s "
            f"({card})")
    new, faces, _ = cu.predictor_volume(u0, dt)
    fhat, _ = cu.face_flux(faces)
    times = {
        "aderdg_predictor_volume": (
            event_ms(torch, lambda: cu.predictor_volume(u0, dt), 20),
            event_ms(torch, lambda: sol.predictor_volume(u0, dt), 3),
        ),
        "face stage": (
            event_ms(torch, lambda: cu.face_surface(new, faces, dt), 20),
            event_ms(torch, lambda: sol.face_surface(new, faces, dt), 3),
        ),
        "aderdg_face_flux": (
            event_ms(torch, lambda: cu.face_flux(faces), 20),
            event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3),
        ),
        "aderdg_surface_update": (
            event_ms(torch, lambda: cu.surface_update(new, fhat, dt), 20),
            event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt), 3),
        ),
    }
    for name, (ms, plain_ms) in times.items():
        say(f"[time] {name}: kernel {ms!r} ms, plain {plain_ms!r} ms "
            f"(CUDA events; {card})")
    del new, faces, fhat
    for label, solver, steps in (("kernel path", cu, 20), ("plain path", sol, 3)):
        idle, busy, wall = idle_share(torch, lambda: solver.run(u0, steps, dt))
        say(f"[idle] {label}, {steps} steps under torch.profiler: device busy "
            f"{busy!r} ms (union of device intervals) of wall {wall!r} ms; "
            f"idle share {idle!r} ({card})")

    # ------------------------------------------ bench.py's own dt, for the record
    kernel_k = first_nonfinite(torch, cu, u0, 1e-4, 30)
    plain_k = first_nonfinite(torch, sol, u0, 1e-4, 30)
    say(f"[dt] bench.py's dt = 1e-4 from the initial state: first non-finite "
        f"state after step {kernel_k} (kernel path), {plain_k} (plain path); "
        "None = finite for 30 steps")

    # Least times of each kernel's work at the bench shape (this run's
    # tensors): the bytes it must move (inputs read once, outputs written
    # once) and the flops of its arithmetic (analytic count).  The face
    # stage's bound is the pair's: the faces and the state read, the state
    # written (F̂ is an intermediate; :func:`face_stage_bytes`).
    ncell = sol.dofs() // (sol.n_nodes**3 * sol.n_vars)
    face_bytes = torch.empty(sol.face_shape, dtype=u0.dtype, device="meta").nbytes
    state_bytes = u0.nbytes
    itemsize = u0.element_size()
    work = {
        "aderdg_predictor_volume": (2 * state_bytes + face_bytes,
                                    predictor_ops(ORDER, sol.picard_iters, ncell)),
        "aderdg_face_flux": (face_flux_bytes(ORDER, ncell, itemsize),
                             face_flux_ops(ORDER, ncell)),
        "aderdg_surface_update": (surface_update_bytes(ORDER, ncell, itemsize),
                                  surface_update_ops(ORDER, ncell)),
        "face stage": (face_stage_bytes(ORDER, ncell, itemsize), face_surface_ops(ORDER, ncell)),
    }
    bounds = {
        name: kernel_report(None if name == "face stage" else cu, name, torch.float32,
                            f"(Euler) {GRID} f32", times[name][0], *work[name], card)
        for name in (*cu.kernels, "face stage")
    }
    replaces = "exahype_tpu/models/aderdg_pallas.py:156"
    kernels = [
        kernel_line(name, replaces, launches[name], errs[name], *times[name], bounds[name])
        for name in cu.kernels
    ]
    kernels.append(kernel_line(
        "aderdg_face_flux + aderdg_surface_update (face stage, Euler)", replaces,
        launches["aderdg_surface_update"], errs["face stage"], *times["face stage"],
        bounds["face stage"]))
    del cu, sol, u0, u
    torch.cuda.empty_cache()
    return kernels


def density_wave(torch, sol, t: float, dtype, periodic: bool = True):
    """``examples/high_order_p5.py:61-76``'s density wave at time ``t``
    (var axis 3): with ``periodic``, each axis shorter than the unit wave
    carries one period over its extent instead (``ST_ORDERS``' note)."""
    import numpy as np

    coords = sol.nodes_meshgrid()
    scale = []
    for g, dx in zip(sol.grid_shape, sol._dxs):
        ext = g * dx
        scale.append(1.0 / ext if periodic and ext < 1.0 else 1.0)
        if periodic and abs(ext * scale[-1] - round(ext * scale[-1])) > 1e-9:
            fail(f"no periodic wave of the example's kind on an axis of extent {ext}")
    phase = sum(k * (np.asarray(c) - v * t) for k, c, v in zip(scale, coords, WAVE_VEL))
    no_var = sol.state_shape[:3] + sol.state_shape[4:]
    rho = np.broadcast_to(np.squeeze(1.0 + 0.2 * np.sin(2 * np.pi * phase), 3), no_var)
    e = WAVE_P0 / (WAVE_GAMMA - 1.0) + 0.5 * rho * sum(v * v for v in WAVE_VEL)
    q = np.stack([rho] + [rho * v for v in WAVE_VEL] + [e], axis=3)
    return torch.from_numpy(q).to(device=sol.weights.device, dtype=dtype).contiguous()


def walled_face_work(sol, cu, order: int, ncell: int, itemsize: int, nvar: int, rows: int,
                     eig_ops: int, masked: bool) -> dict:
    """Bytes and flops of the walled face stage and its launches: those of
    the periodic stage, plus the side tensor (written by the flux kernel,
    read by the update) and any Dirichlet rows read, and one more Rusanov
    flux a low-wall face node."""
    side = cu.walls["size"] * itemsize
    dirichlet = 2 * side if sol.boundary == "dirichlet" else 0
    low = cu.walls["size"] // nvar
    extra_ops = low * (2 * eig_ops + (7 if masked else 6) * nvar)
    em = dict(nvar=nvar, eig_ops=eig_ops, masked=masked)
    return {
        cu.kernels[1]: (
            face_flux_bytes(order, ncell, itemsize, nvar=nvar, rows=rows) + side + dirichlet,
            face_flux_ops(order, ncell, **em) + extra_ops),
        cu.kernels[2]: (
            surface_update_bytes(order, ncell, itemsize, rows=rows) + side,
            surface_update_ops(order, ncell, nvar=rows)),
        "face stage": (
            face_stage_bytes(order, ncell, itemsize, nvar=nvar, rows=rows) + side
            + dirichlet, face_surface_ops(order, ncell, **em) + extra_ops),
    }


def st_kernel_stages(torch, sol, cu, u, dt):
    """Each kernel of a periodic order-generic step and the step against
    its plain version on ``u``: ``[(name, what, got, ref)]``."""
    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = sol.predictor_volume(u, dt)
    fhat_k, fhat_p = cu.face_flux(faces_p)[0], plain_face_flux(torch, sol, faces_p)
    upd_k = cu.surface_update(new_p.clone(), fhat_p, dt)
    upd_p = plain_surface_update(sol, new_p, fhat_p, dt)
    surf_k = cu.face_surface(new_p.clone(), faces_p, dt)
    surf_p = sol.face_surface(new_p, faces_p, dt)
    step_k, step_p = cu.step(u, dt), sol.step(u, dt)
    torch.cuda.synchronize()
    return [
        (cu.kernels[0], "new", new_k, new_p),
        (cu.kernels[0], "faces", faces_k, faces_p),
        (cu.kernels[1], "fhat", fhat_k, fhat_p),
        (cu.kernels[2], "new", upd_k, upd_p),
        ("face stage", "new", surf_k, surf_p),
        ("step", "new", step_k, step_p),
    ]


def st_orders_path(torch, dev, card) -> list[dict]:
    """The order-generic Euler path (``ST_ORDERS``' note): at orders 4, 5
    and 7 ``CudaADERDG``'s space-time predictor (``csrc/aderdg_st.cuh``)
    and the face stage at n = 5, 6, 8, periodic and walled; then the order
    anchor.  Returns the kernel JSON lines of each order's five kernels at
    its first grid."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

    flux, eig = euler_physics(3, n_real=5, gamma=WAVE_GAMMA)
    replaces = "exahype_tpu/models/aderdg_pallas.py:156"
    t_path = time.perf_counter()

    def make(order, grid, dtype, walls=None):
        sol = ADERDGSolver(3, order, 5, grid, flux, eig, dx=1.0 / grid[0], device=dev,
                           dtype=dtype, **(walls or {}))
        return sol, CudaADERDG(sol)

    def walls_of(name, order, grid):
        return euler_walls(name, grid, order=order, dx=1.0 / grid[0])

    def phase(what):
        say(f"[st] {what}: {time.perf_counter() - t_path:.1f} s into the path (host clock)")

    lines, gib = [], 2.0**-30
    for order in ST_ORDERS:
        tag = f"p{order}"
        # --------------------------------- f64 parity on the cut grid
        cut = ST_CUTS[order]
        sol, cu = make(order, cut, torch.float64)
        rng = np.random.default_rng(order)
        u = density_wave(torch, sol, 0.0, torch.float64)
        u[:, :, :, 0] *= 1.0 + 0.05 * torch.from_numpy(
            rng.standard_normal(u[:, :, :, 0].shape)).to(u)
        cut_cfl = float(cu.cfl_dt(u))
        for dt in (ST_DT[order] or 0.25 * cut_cfl, 0.5 * cut_cfl):
            for name, what, got, ref in st_kernel_stages(torch, sol, cu, u, dt):
                err = max_err(torch, got, ref)
                limit = ST_F64_RTOL * max(1.0, ref.abs().max().item())
                ok = err <= limit
                say(f"[{tag} parity] {name} ({what}) float64 {cut} dt {dt!r}: max_abs_err "
                    f"{err:.3e} limit {limit:.3e} (1e-12 of max(1, max|plain|)) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{name} disagrees with its plain version (float64, {cut})")
        for mode in ST_WALLS:
            wsol, wcu = make(order, cut, torch.float64, walls_of(mode, order, cut))
            walls_parity(torch, wsol, wcu, u, 0.5 * cut_cfl, f"Euler p{order} {mode}", 5,
                         [(0, 5)])
        del sol, cu, wsol, wcu, u
        phase(f"order {order}: the float64 parity, periodic and every wall mode")

        for grid in ST_GRIDS[order]:
            first = grid == ST_GRIDS[order][0]
            sol, cu = make(order, grid, torch.float32)
            u0 = density_wave(torch, sol, 0.0, torch.float32)
            cfl = float(cu.cfl_dt(u0))
            dt = ST_DT[order] or cfl
            say(f"[{tag} main] {grid} f32, {sol.dofs()} DOF: dt = {dt!r} ("
                + ("examples/high_order_p5.py:77" if ST_DT[order] else "cfl_dt")
                + f"), cfl_dt {cfl!r}")
            if not dt <= cfl:
                fail(f"dt {dt} is above cfl_dt {cfl} at {grid}")

            # ------------------------------ each kernel against plain, f32
            errs = {}
            for name, what, got, ref in st_kernel_stages(torch, sol, cu, u0, dt):
                err, limit = max_err(torch, got, ref), f32_bound(torch, ref)
                ok = err <= limit
                say(f"[{tag} parity] {name} ({what}) float32 {grid}: max_abs_err {err:.3e} "
                    f"limit {limit:.3e} ({F32_ULPS} f32 spacings of max|plain|) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{name} disagrees with its plain version (float32, {grid})")
                errs[name] = max(errs.get(name, 0.0), err)

            # ------------------------------------------------- main path
            torch.cuda.synchronize()
            cu.reset_launches()
            u = cu.run(u0, STEPS, dt)
            torch.cuda.synchronize()
            launches = dict(cu.launches)
            say(f"[{tag} main] {STEPS} steps of {grid} f32 through CudaADERDG: launches "
                f"{launches}")
            if launches != {name: STEPS for name in cu.kernels}:
                fail(f"the order-{order} step launched {launches} in {STEPS} steps")
            if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
                fail(f"the order-{order} state is not finite or has the wrong shape")
            exact = density_wave(torch, sol, STEPS * dt, torch.float64)
            err = max_err(torch, u, exact)
            m0, m1 = (float(cu.total_mass(x.double())[0]) for x in (u0, u))
            say(f"[{tag} main] {grid}: max error against the exact wave at t = "
                f"{STEPS * dt!r}: {err:.3e} (gate {ST_ERR_GATE}); mass drift "
                f"{abs(m1 - m0):.3e} (gate {ST_MASS_GATE}, mass {m0!r})")
            if not (err < ST_ERR_GATE and abs(m1 - m0) < ST_MASS_GATE):
                fail(f"the order-{order} step misses the example's error or mass gate at "
                     f"{grid}")
            if not torch.equal(u, cu.run(u0, STEPS, dt)):
                fail(f"two order-{order} runs from the same state differ")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            plain_u = sol.run(u0, ST_PLAIN_STEPS, dt)
            torch.cuda.synchronize()
            say(f"[{tag} mem] plain path {grid}, {ST_PLAIN_STEPS} steps: peak "
                f"{torch.cuda.max_memory_allocated() * gib:.4f} GiB allocated ({held * gib:.4f} "
                f"GiB held before) of "
                f"{torch.cuda.get_device_properties(0).total_memory * gib:.1f} GiB ({card})")
            u_n = cu.run(u0, ST_PLAIN_STEPS, dt)
            run_err = max_err(torch, u_n, plain_u)
            run_bound = ST_PLAIN_STEPS * f32_bound(torch, plain_u)
            say(f"[{tag} main] two runs bitwise equal; {ST_PLAIN_STEPS}-step kernel path vs "
                f"plain path: max_abs_err {run_err:.3e} limit {run_bound:.3e}")
            if not run_err <= run_bound:
                fail(f"the order-{order} kernel path disagrees with the plain path")
            del plain_u, u_n
            seam = density_wave(torch, sol, 0.0, torch.float32, periodic=False)
            seam_u = cu.run(seam, STEPS, dt)
            seam_err = max_err(torch, seam_u, density_wave(torch, sol, STEPS * dt, torch.float64,
                                                      periodic=False))
            say(f"[{tag} reading] {grid}: the example's wave as written (the axes shorter "
                f"than 1 not periodic for it): error against the formula after {STEPS} steps "
                f"{seam_err:.3e}")
            del seam, seam_u, exact, u

            # ------------------------------------------------------ times
            dofs = cu.dofs()
            k_win = windows(torch, cu, u0, dt, steps=20)
            p_win = windows(torch, sol, u0, dt, steps=1, n_windows=1)
            for label, win in (("kernel path", k_win), ("plain path", p_win)):
                ms = [1e3 * w for w in win]
                say(f"[{tag} time] {grid} {label}: step ms per window {ms!r}; median "
                    f"{statistics.median(ms)!r} ms, {dofs / statistics.median(win)!r} "
                    f"DOF-updates/s ({card})")
            new, faces, _ = cu.predictor_volume(u0, dt)
            fhat, _ = cu.face_flux(faces)
            times = {
                cu.kernels[0]: (event_ms(torch, lambda: cu.predictor_volume(u0, dt), 20),
                                once_ms(torch, lambda: sol.predictor_volume(u0, dt))),
                cu.kernels[1]: (event_ms(torch, lambda: cu.face_flux(faces), 20),
                                once_ms(torch, lambda: plain_face_flux(torch, sol, faces))),
                cu.kernels[2]: (event_ms(torch, lambda: cu.surface_update(new, fhat, dt), 20),
                                once_ms(torch, lambda: plain_surface_update(sol, new, fhat,
                                                                            dt))),
            }
            for name, (ms, plain_ms) in times.items():
                say(f"[{tag} time] {grid} {name}: kernel {ms!r} ms, plain {plain_ms!r} ms "
                    f"(CUDA events; {card})")
            del new, fhat
            idle, busy, wall = idle_share(torch, lambda: cu.run(u0, 20, dt))
            say(f"[{tag} idle] {grid} kernel path, 20 steps under torch.profiler: device busy "
                f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")
            ncell = math.prod(grid)
            itemsize = u0.element_size()
            face_bytes = torch.empty(sol.face_shape, dtype=u0.dtype, device="meta").nbytes
            work = {
                cu.kernels[0]: (2 * u0.nbytes + face_bytes,
                                predictor_ops(order, sol.picard_iters, ncell)),
                cu.kernels[1]: (face_flux_bytes(order, ncell, itemsize),
                                face_flux_ops(order, ncell)),
                cu.kernels[2]: (surface_update_bytes(order, ncell, itemsize),
                                surface_update_ops(order, ncell)),
            }
            for name in cu.kernels:
                bnd = kernel_report(cu, name, torch.float32, f"(Euler p{order}) {grid} f32",
                                    times[name][0], *work[name], card)
                if first:
                    source = ("exahype_tpu_torch/csrc/aderdg_st.cuh" if name == cu.kernels[0]
                              else "exahype_tpu_torch/csrc/aderdg.cu")
                    lines.append(kernel_line(name, replaces, launches[name], errs[name],
                                             *times[name], bnd, source=source))
            phase(f"order {order} {grid}: parity, main path, times")
            if first:
                lines += st_walls_full(torch, card, order, grid, sol, cu, make, walls_of,
                                       faces, u0, dt)
                phase(f"order {order} {grid}: walls")
            del sol, cu, u0, faces
            torch.cuda.empty_cache()

    # ------------------------------------------------ the order anchor
    errors = {}
    for order in ST_ANCHOR_ORDERS:
        sol, cu = make(order, ST_ANCHOR_GRID, torch.float64)
        u0 = density_wave(torch, sol, 0.0, torch.float64)
        dt = ST_ANCHOR_T / ST_ANCHOR_STEPS
        if not dt <= float(cu.cfl_dt(u0)):
            fail(f"the anchor's dt {dt} is above cfl_dt at order {order}")
        cu.reset_launches()
        u = cu.run(u0, ST_ANCHOR_STEPS, dt)
        torch.cuda.synchronize()
        if dict(cu.launches) != {name: ST_ANCHOR_STEPS for name in cu.kernels}:
            fail(f"the anchor at order {order} launched {dict(cu.launches)}")
        errors[order] = max_err(torch, u, density_wave(torch, sol, ST_ANCHOR_T, torch.float64))
    say(f"[st anchor] the exact wave on {ST_ANCHOR_GRID} (dx = 1/4) at t = {ST_ANCHOR_T} in "
        f"{ST_ANCHOR_STEPS} steps, float64 through the kernels: max error by order {errors!r}")
    for lo, hi in zip(ST_ANCHOR_ORDERS, ST_ANCHOR_ORDERS[1:]):
        if not (errors[hi] < errors[lo] or errors[hi] < ST_ANCHOR_FLOOR):
            fail(f"the error did not fall from order {lo} to order {hi}: {errors}")
    phase("the order anchor")
    return lines


def st_walls_full(torch, card, order, grid, psol, pcu, make, walls_of, pfaces, u0, dt):
    """The walled modes of an order-generic step at full width in float32
    (``ST_ORDERS``' note): the walled pair against plain launch by launch,
    the reflective box's 10 steps with its gates (the main path's launches of
    the walled pair), the outflow and farfield channels, and the walled pair
    timed beside the periodic one on the same faces.  Returns the JSON lines
    of the walled pair."""
    tag = f"p{order}"
    sol, cu = make(order, grid, torch.float32, walls_of("reflective box", order, grid))
    errs = walls_parity(torch, sol, cu, u0, dt, f"Euler p{order} reflective box", 5, [(0, 5)])
    cu.reset_launches()
    u = cu.run(u0, STEPS, dt)
    torch.cuda.synchronize()
    launches = dict(cu.launches)
    say(f"[{tag} walls] {STEPS} steps of the reflective box {grid} f32 through CudaADERDG "
        f"(dt = {dt!r}): launches {launches}")
    if launches != {name: STEPS for name in cu.kernels}:
        fail(f"the walled order-{order} step launched {launches} in {STEPS} steps")
    if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
        fail(f"the order-{order} reflective box's state is not finite or has the wrong shape")
    m0, m1 = cu.total_mass(u0.double()), cu.total_mass(u.double())
    rel = ((m1 - m0).abs() / m0.abs()).tolist()
    say(f"[{tag} walls] relative change over {STEPS} steps: mass {rel[0]:.3e}, energy "
        f"{rel[4]:.3e} (limit {MASS_RTOL:.1e}); momentum {rel[1]:.3e}, {rel[2]:.3e}, "
        f"{rel[3]:.3e} (the walls' pressure acts: must exceed {MASS_RTOL:.1e})")
    if not (rel[0] <= MASS_RTOL and rel[4] <= MASS_RTOL):
        fail(f"the order-{order} reflective box leaks mass or energy")
    if not min(rel[1:4]) > MASS_RTOL:
        fail(f"the order-{order} reflective walls did not change the momentum")
    if not torch.equal(u, cu.run(u0, STEPS, dt)):
        fail(f"two runs of the order-{order} reflective box differ")
    plain_u = sol.run(u0, ST_PLAIN_STEPS, dt)
    run_err = max_err(torch, cu.run(u0, ST_PLAIN_STEPS, dt), plain_u)
    run_bound = ST_PLAIN_STEPS * f32_bound(torch, plain_u)
    say(f"[{tag} walls] two runs bitwise equal; {ST_PLAIN_STEPS}-step kernel path vs plain "
        f"path: max_abs_err {run_err:.3e} limit {run_bound:.3e}")
    if not run_err <= run_bound:
        fail(f"the order-{order} reflective box disagrees with the plain path")
    del plain_u, u
    for mode in ("outflow (0,)", "farfield (0,)"):
        osol, ocu = make(order, grid, torch.float32, walls_of(mode, order, grid))
        start = u0
        if mode == "farfield (0,)":  # the farfield state everywhere: steady
            shape = [1] * len(osol.state_shape)
            shape[osol.var_axis] = 5
            start = torch.tensor(FARFIELD, dtype=torch.float32, device=u0.device).reshape(
                shape).expand(osol.state_shape).contiguous()
        odt = min(dt, float(ocu.cfl_dt(start)))
        ocu.reset_launches()
        u = ocu.run(start, STEPS, odt)
        torch.cuda.synchronize()
        ok = bool(torch.isfinite(u).all()) and dict(ocu.launches) == {
            name: STEPS for name in ocu.kernels}
        drift = max_err(torch, u, start)
        limit = STEPS * f32_bound(torch, start)
        steady = mode != "farfield (0,)" or drift <= limit
        say(f"[{tag} walls] {mode} {grid} f32, {STEPS} steps at dt {odt!r}: launches "
            f"{dict(ocu.launches)}; finite {bool(torch.isfinite(u).all())}"
            + (f"; the uniform farfield flow: max |u - u0| {drift:.3e} limit {limit:.3e}"
               if mode == "farfield (0,)" else ""))
        if not (ok and steady):
            fail(f"the order-{order} {mode} step is not finite, launched wrongly or did not "
                 "stay steady")
        del osol, ocu, u, start
    new, faces, _ = cu.predictor_volume(u0, dt)
    fhat, fwall = cu.face_flux(faces)
    walls = cu.wall_fluxes(fwall)
    pnew, _, _ = pcu.predictor_volume(u0, dt)
    pfhat, _ = pcu.face_flux(pfaces)
    times = {
        cu.kernels[1]: (event_ms(torch, lambda: cu.face_flux(faces), 20),
                        once_ms(torch, lambda: plain_face_flux(torch, sol, faces))),
        cu.kernels[2]: (event_ms(torch, lambda: cu.surface_update(new, fhat, dt, fwall), 20),
                        once_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt, walls))),
    }
    periodic = {
        cu.kernels[1]: event_ms(torch, lambda: pcu.face_flux(pfaces), 20),
        cu.kernels[2]: event_ms(torch, lambda: pcu.surface_update(pnew, pfhat, dt), 20),
    }
    ncell = math.prod(grid)
    work = walled_face_work(sol, cu, order, ncell, u0.element_size(), 5, 5, EIG_OPS, False)
    out = []
    for name in cu.kernels[1:]:
        ms, plain_ms = times[name]
        say(f"[{tag} walls time] {grid} {name}: kernel {ms!r} ms, plain {plain_ms!r} ms; "
            f"the periodic kernel on the same faces {periodic[name]!r} ms (CUDA events; {card})")
        bnd = kernel_report(cu, name, torch.float32, f"(Euler p{order} reflective box) {grid} "
                            "f32", ms, *work[name], card)
        out.append(kernel_line(name, "exahype_tpu/models/aderdg_pallas.py:156",
                               launches[name], errs[name], ms, plain_ms, bnd))
    del sol, cu, new, faces, fhat, fwall, pnew, pfhat
    torch.cuda.empty_cache()
    return out


def dirichlet_state(*x):
    """A smooth Euler state (var last) for the Dirichlet walls, whose rows
    vary over every face of the cut grid (wavelength 1/8: 32 cells at
    dx = 1/256)."""
    import numpy as np

    k = 16 * math.pi
    rho = 1.0 + 0.2 * np.sin(k * x[0]) * np.cos(k * x[2])
    vel = [0.3 + 0.1 * np.cos(k * x[d]) for d in range(3)]
    p = 2.0 + 0.1 * np.sin(k * x[1])
    e = p / 0.4 + 0.5 * rho * sum(v * v for v in vel)
    return np.stack([rho] + [rho * v for v in vel] + [e], axis=-1)


def euler_walls(name: str, grid, order: int = ORDER, dx: float = DX) -> dict:
    """The wall options of each Euler mode of the walls path (the Dirichlet
    rows at ``order`` on ``grid`` at ``dx``)."""
    from exahype_tpu_torch.models.aderdg import (
        euler_reflect,
        euler_reflect_flux,
        make_dirichlet_fn,
    )

    mirror = dict(reflect_fn=euler_reflect(3), reflect_flux_fn=euler_reflect_flux(3))
    return {
        "reflective box": dict(boundary="reflective", **mirror),
        "outflow (0,)": dict(boundary="outflow", wall_axes=(0,)),
        "farfield (0,)": dict(boundary="farfield", farfield_state=FARFIELD, wall_axes=(0,)),
        "dirichlet box": dict(boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(
            dirichlet_state, dim=3, order=order, grid_shape=grid, dx=dx)),
        "reflective (1, 2)": dict(boundary="reflective", wall_axes=(1, 2), **mirror),
    }[name]


def walls_parity(torch, sol, cu, u, dt, label: str, rows: int, groups) -> dict:
    """The walled face stage against the plain solver on ``u``: each launch
    (``aderdg_face_flux_walls``' F̂ and its side tensor of low-wall fluxes,
    ``aderdg_surface_update_walls`` from the plain F̂ and low-wall fluxes), the
    stage (both launches) and the step.  ``rows`` are the rows with a flux;
    ``groups`` the var rows ``(lo, n)`` of a state each held against the
    bound of its own largest value in float32 (atol 1e-12 in float64).
    Fails on a disagreement; returns the largest error of each."""
    f64 = u.dtype == torch.float64
    rule = "atol" if f64 else f"{F32_ULPS} f32 spacings of max|plain|"
    fshape = sol.face_flux_shape
    new, faces, _ = sol.predictor_volume(u, dt)
    fhat_k, fwall_k = cu.face_flux(faces)
    fhat_p, wall_p = [], {}
    for d in range(sol.dim):
        q_lo, q_hi, f_lo, f_hi = (faces[d, k].reshape(fshape) for k in range(4))
        fhat_p.append(sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d))
        if sol.is_wall(d):
            wall_p[d] = sol.low_wall_flux(q_lo, f_lo, d)
    fwall_p = torch.cat([wall_p[d].reshape(-1) for d in sorted(wall_p)])
    upd_k = cu.surface_update(new.clone(), torch.stack(fhat_p).view(fhat_k.shape), dt, fwall_p)
    upd_p = plain_surface_update(sol, new, torch.stack(fhat_p), dt, wall_p)
    stage_k = cu.face_surface(new.clone(), faces, dt)
    stage_p = sol.face_surface(new, faces, dt)
    step_k, step_p = cu.step(u, dt), sol.step(u, dt)
    torch.cuda.synchronize()
    faces_cmp = [(f"fhat[{d}]", fhat_k[d].view(fshape), fhat_p[d]) for d in range(sol.dim)]
    faces_cmp += [(f"fwall[{d}]", cu.wall_fluxes(fwall_k)[d], wall_p[d]) for d in wall_p]
    flux_name, update_name = cu.kernels[1:]
    checks = [(flux_name, what, g.narrow(2, 0, rows), r.narrow(2, 0, rows), 2,
               [(0, rows)]) for what, g, r in faces_cmp]
    checks += [(update_name, "new", upd_k, upd_p, 3, groups),
               ("face stage", "new", stage_k, stage_p, 3, groups),
               ("step", "new", step_k, step_p, 3, groups)]
    errs = {}
    for name, what, got, ref, va, grps in checks:
        for lo, n in grps:
            g, r = got.narrow(va, lo, n), ref.narrow(va, lo, n)
            err = max_err(torch, g, r)
            limit = F64_ATOL if f64 else f32_bound(torch, r)
            ok = err <= limit
            say(f"[walls parity] {label}: {name} ({what}, rows {lo}-{lo + n - 1}) "
                f"{str(u.dtype)[6:]} {sol.grid_shape}: max_abs_err {err:.3e} limit "
                f"{limit:.3e} ({rule}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"walled {name} ({what}) disagrees with its plain version ({label}, "
                     f"{u.dtype}, {sol.grid_shape})")
            errs[name] = max(errs.get(name, 0.0), err)
    return errs


def walls_path(torch, dev, card) -> list[dict]:
    """The walls path: the face stage's wall variant against plain in every
    mode (f64, cut grid), then at full width in f32 the reflective box, the
    farfield channel and the CK free surface, with their times; returns the
    kernel JSON lines of the walled face stage (Euler box, CK free
    surface)."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.elastic import (
        DISSIPATION_MASK,
        MATERIAL_SLOTS,
        N_VARS_3D_HET,
        elastic3d_free_surface_het,
        elastic3d_heterogeneous,
        seismic_energy,
        two_layer_state,
    )

    flux, eig = euler_physics(3, n_real=5)
    eflux, eeig = elastic3d_heterogeneous()
    E = CK_EVOLVED
    euler_groups, ck_groups = [(0, 5)], [(0, E), (E, N_VARS_3D_HET - E)]

    def make_euler(grid, dtype, walls):
        sol = ADERDGSolver(3, ORDER, 5, grid, flux, eig, dx=DX, device=dev, dtype=dtype,
                           **walls)
        return sol, CudaADERDG(sol)

    def make_ck(grid, dtype):
        refl, refl_flux = elastic3d_free_surface_het()
        sol = ADERDGSolver(3, ORDER, N_VARS_3D_HET, grid, eflux, eeig, dx=1.0 / grid[0],
                           device=dev, dtype=dtype, predictor_mode="ck",
                           ck_material_slots=MATERIAL_SLOTS, dissipation_mask=DISSIPATION_MASK,
                           boundary="reflective", reflect_fn=refl, reflect_flux_fn=refl_flux,
                           wall_axes=FREE_SURFACE_AXES)
        q, mat = two_layer_state(sol)
        return (sol, CudaADERDG(sol), torch.from_numpy(q).to(dev, dtype).contiguous(),
                torch.from_numpy(np.ascontiguousarray(mat)).to(dev, dtype))

    def uniform(sol, dtype):
        """The farfield state everywhere: a uniform supersonic flow."""
        shape = [1] * len(sol.state_shape)
        shape[sol.var_axis] = 5
        st = torch.tensor(FARFIELD, dtype=dtype, device=dev).reshape(shape)
        return st.expand(sol.state_shape).contiguous()

    # ---------------------------------- 3. f64, every mode, cut grid
    for name in ("reflective box", "outflow (0,)", "farfield (0,)", "dirichlet box",
                 "reflective (1, 2)"):
        walls = euler_walls(name, WALL_CUT)
        sol, cu = make_euler(WALL_CUT, torch.float64, walls)
        u = bench_state(sol, torch, dev, torch.float64)
        if name == "dirichlet box":
            row = walls["dirichlet_fn"](0, 0)
            say(f"[walls] dirichlet rows: (0, 0) spans {np.ptp(row, axis=(0, 1, 3, 4, 5))!r} "
                "by variable over the face")
        walls_parity(torch, sol, cu, u, float(sol.cfl_dt(u)), f"Euler {name}", 5, euler_groups)
    sol, cu, u, mat = make_ck(WALL_CUT, torch.float64)
    errs = walls_parity(torch, sol, cu, u, float(sol.cfl_dt(u)), "CK free surface", E, ck_groups)
    del sol, cu, u, mat

    lines = []
    gib = 2.0**-30
    ncell = math.prod(GRID)
    n_nodes = ORDER + 1

    def face_times(sol, cu, u, dt):
        new, faces, _ = cu.predictor_volume(u, dt)
        fhat, fwall = cu.face_flux(faces)
        walls = {} if fwall is None else cu.wall_fluxes(fwall)
        out = {
            "face stage": (event_ms(torch, lambda: cu.face_surface(new, faces, dt), 20),
                           event_ms(torch, lambda: sol.face_surface(new, faces, dt), 3)),
            "flux": (event_ms(torch, lambda: cu.face_flux(faces), 20),
                     event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 3)),
            "update": (
                event_ms(torch, lambda: cu.surface_update(new, fhat, dt, fwall), 20),
                event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt, walls), 3)),
        }
        return {cu.kernels[1]: out["flux"], cu.kernels[2]: out["update"],
                "face stage": out["face stage"]}

    # ---------------------------------- 4. the reflective box at full width
    sol, cu = make_euler(GRID, torch.float32, euler_walls("reflective box", GRID))
    u0 = bench_state(sol, torch, dev, torch.float32)
    dt = float(cu.cfl_dt(u0))
    errs_box = walls_parity(torch, sol, cu, u0, dt, "Euler reflective box", 5, euler_groups)
    cu.reset_launches()
    u = cu.run(u0, STEPS, dt)
    torch.cuda.synchronize()
    launches = dict(cu.launches)
    say(f"[walls main] {STEPS} steps of the reflective box {GRID} f32 through CudaADERDG "
        f"(dt = cfl_dt = {dt!r}): launches {launches}")
    if launches != {name: STEPS for name in cu.kernels}:
        fail(f"the walled step launched {launches} in {STEPS} steps, expected 3 a step")
    if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
        fail("the reflective box's state is not finite or has the wrong shape")
    m0, m1 = cu.total_mass(u0.double()), cu.total_mass(u.double())
    rel = ((m1 - m0).abs() / m0.abs()).tolist()
    say(f"[walls main] relative change over {STEPS} steps: mass {rel[0]:.3e}, energy "
        f"{rel[4]:.3e} (limit {MASS_RTOL:.1e}); momentum {rel[1]:.3e}, {rel[2]:.3e}, "
        f"{rel[3]:.3e} (the walls' pressure acts: must exceed {MASS_RTOL:.1e})")
    if not (rel[0] <= MASS_RTOL and rel[4] <= MASS_RTOL):
        fail("the reflective box leaks mass or energy")
    if not min(rel[1:4]) > MASS_RTOL:
        fail("the reflective walls did not change the momentum")
    if not torch.equal(u, cu.run(u0, STEPS, dt)):
        fail("two runs of the reflective box differ")
    say("[walls main] two runs from the same state: bitwise equal")
    plain_u = sol.run(u0, STEPS, dt)
    run_err, run_bound = max_err(torch, u, plain_u), STEPS * f32_bound(torch, plain_u)
    say(f"[walls main] {STEPS}-step kernel path vs plain path: max_abs_err {run_err:.3e} "
        f"limit {run_bound:.3e}")
    if not run_err <= run_bound:
        fail("the reflective box disagrees with the plain path")
    del plain_u, u

    # ---------------------------------- 5. times: walled against periodic
    psol, pcu = make_euler(GRID, torch.float32, {})
    dofs = cu.dofs()
    wins = {}
    for label, solver in (("periodic", pcu), ("walled", cu), ("walled ", cu),
                          ("periodic ", pcu)):
        wins.setdefault(label.strip(), []).extend(windows(torch, solver, u0, dt, steps=20))
    for label, win in wins.items():
        ms = [1e3 * w for w in win]
        say(f"[walls time] {label} step (Euler {GRID} f32): step ms per window {ms!r}; "
            f"median {statistics.median(ms)!r} ms, {dofs / statistics.median(win)!r} "
            f"DOF-updates/s ({card})")
    times = face_times(sol, cu, u0, dt)
    ptimes = face_times(psol, pcu, u0, dt)
    for (name, (ms, plain_ms)), periodic in zip(times.items(), ptimes.values()):
        say(f"[walls time] {name} (Euler reflective box): kernel {ms!r} ms, plain "
            f"{plain_ms!r} ms; periodic kernel {periodic[0]!r} ms (CUDA events; {card})")
    idle, busy, wall = idle_share(torch, lambda: cu.run(u0, 20, dt))
    say(f"[walls idle] reflective box, 20 steps under torch.profiler: device busy {busy!r} "
        f"ms of wall {wall!r} ms; idle share {idle!r} ({card})")
    work = walled_face_work(sol, cu, ORDER, ncell, u0.element_size(), 5, 5, EIG_OPS, False)
    replaces = "exahype_tpu/models/aderdg_pallas.py:156"
    for name in (*cu.kernels[1:], "face stage"):
        bnd = kernel_report(None if name == "face stage" else cu, name, torch.float32,
                            f"(walls, Euler reflective box) {GRID} f32", times[name][0],
                            *work[name], card)
        label = (f"{cu.kernels[1]} + {cu.kernels[2]} (face stage, Euler reflective box)"
                 if name == "face stage" else f"{name} (Euler reflective box)")
        count = launches[cu.kernels[2] if name == "face stage" else name]
        lines.append(kernel_line(label, replaces, count, errs_box[name], *times[name], bnd))
    del psol, pcu, sol, cu, u0
    torch.cuda.empty_cache()

    # ---------------------------------- 6. the farfield channel at full width
    sol, cu = make_euler(GRID, torch.float32, euler_walls("farfield (0,)", GRID))
    u0 = uniform(sol, torch.float32)
    dt = float(cu.cfl_dt(u0))
    walls_parity(torch, sol, cu, bench_state(sol, torch, dev, torch.float32), dt,
                 "Euler farfield (0,)", 5, euler_groups)
    cu.reset_launches()
    u = cu.run(u0, STEPS, dt)
    torch.cuda.synchronize()
    drift, limit = max_err(torch, u, u0), STEPS * f32_bound(torch, u0)
    say(f"[walls main] farfield channel {GRID} f32, the uniform supersonic flow equal to the "
        f"farfield state, {STEPS} steps at cfl_dt = {dt!r}: launches {dict(cu.launches)}; "
        f"max |u - u0| {drift:.3e} limit {limit:.3e} ({STEPS} x {F32_ULPS} f32 spacings)")
    if not (torch.isfinite(u).all() and drift <= limit):
        fail("the farfield channel's uniform flow did not stay steady")
    del sol, cu, u0, u
    torch.cuda.empty_cache()

    # ---------------------------------- 7. the CK free surface at full width
    sol, cu, u0, mat = make_ck(GRID, torch.float32)
    dt = float(sol.cfl_dt(u0))
    errs_ck = walls_parity(torch, sol, cu, u0, dt, "CK free surface", E, ck_groups)
    e = lambda q: float(seismic_energy(q.double(), 3, mat.double()))  # noqa: E731
    cu.reset_launches()
    u = cu.run(u0, STEPS, dt)
    torch.cuda.synchronize()
    ck_launches = dict(cu.launches)
    frozen = torch.equal(u.narrow(3, E, N_VARS_3D_HET - E), mat)
    ratio = e(u) / e(u0)
    say(f"[walls main] CK free surface {GRID} f32, wall_axes {FREE_SURFACE_AXES}, {STEPS} "
        f"steps at cfl_dt = {dt!r}: launches {ck_launches}; finite "
        f"{bool(torch.isfinite(u).all())}; slots 9-11 bitwise frozen {frozen}; energy ratio "
        f"{ratio!r} (gate {CK_ENERGY_GATE}, bench.py:280)")
    if ck_launches != {name: STEPS for name in cu.kernels}:
        fail(f"the CK free surface launched {ck_launches} in {STEPS} steps")
    if not (torch.isfinite(u).all() and frozen and ratio < CK_ENERGY_GATE):
        fail("the CK free surface is not finite, moved its materials or gained energy")
    if not torch.equal(u, cu.run(u0, STEPS, dt)):
        fail("two runs of the CK free surface differ")
    plain_u = sol.run(u0, STEPS, dt)
    run_err = max_err(torch, u.narrow(3, 0, E), plain_u.narrow(3, 0, E))
    run_bound = STEPS * f32_bound(torch, plain_u.narrow(3, 0, E))
    say(f"[walls main] CK free surface {STEPS}-step kernel path vs plain path (evolved "
        f"rows): max_abs_err {run_err:.3e} limit {run_bound:.3e}; two runs bitwise equal")
    if not run_err <= run_bound:
        fail("the CK free surface disagrees with the plain path")
    del plain_u, u
    k_win = windows(torch, cu, u0, dt, steps=20)
    ms = [1e3 * w for w in k_win]
    say(f"[walls time] CK free surface step {GRID} f32: step ms per window {ms!r}; median "
        f"{statistics.median(ms)!r} ms ({card})")
    times = face_times(sol, cu, u0, dt)
    for name, (t, plain_t) in times.items():
        say(f"[walls time] {name} (CK free surface): kernel {t!r} ms, plain {plain_t!r} ms "
            f"(CUDA events; {card})")
    work = walled_face_work(sol, cu, ORDER, ncell, u0.element_size(), N_VARS_3D_HET, E,
                            ELASTIC_EIG_OPS, True)
    for name in (*cu.kernels[1:], "face stage"):
        bnd = kernel_report(None if name == "face stage" else cu, name, torch.float32,
                            f"(walls, CK free surface) {GRID} f32", times[name][0],
                            *work[name], card)
        label = (f"{cu.kernels[1]} + {cu.kernels[2]} (face stage, CK free surface)"
                 if name == "face stage" else f"{name} (CK free surface)")
        count = ck_launches[cu.kernels[2] if name == "face stage" else name]
        lines.append(kernel_line(label, replaces, count, errs_ck[name], *times[name], bnd))
    say(f"[walls mem] peak allocated so far {torch.cuda.max_memory_allocated() * gib:.4f} GiB")
    del sol, cu, u0, mat
    torch.cuda.empty_cache()
    return lines


def ns_solver(torch, dev, grid, dtype, mu=NS_MU, prandtl=NS_PRANDTL, walls=False, dx=None):
    """A 3-D p3 Navier–Stokes solver on the unit box (dx_d = 1/g_d unless
    ``dx`` is given; no-slip walls on ``NS_WALL_AXES``, outflow walls there,
    or periodic) and its ``CudaADERDG``."""
    from exahype_tpu_torch.models.aderdg import ADERDGSolver
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.navier_stokes import (
        navier_stokes,
        noslip_reflect,
        noslip_reflect_flux,
    )

    flux, eig, visc, visc_eig = navier_stokes(3, mu=mu, prandtl=prandtl)
    kw = {}
    if walls == "noslip":
        kw = dict(boundary="reflective", reflect_fn=noslip_reflect(3),
                  reflect_flux_fn=noslip_reflect_flux(3), wall_axes=NS_WALL_AXES)
    elif walls == "outflow":
        kw = dict(boundary="outflow", wall_axes=NS_WALL_AXES)
    sol = ADERDGSolver(3, ORDER, 5, grid, flux, eig, dx=dx or tuple(1.0 / g for g in grid),
                       device=dev, dtype=dtype,
                       visc_flux_fn=visc, visc_eigenvalue_fn=visc_eig, **kw)
    return sol, CudaADERDG(sol)


def ns_state(torch, sol, dtype, fields):
    """A state from the var-last NumPy fields (ρ, velocity, p) at the nodes."""
    import numpy as np

    rho, vel, p = fields
    e = p / 0.4 + 0.5 * rho * sum(v * v for v in vel)
    q = np.stack([rho] + [rho * v for v in vel] + [e], axis=sol.var_axis)
    return torch.from_numpy(q).to(device=sol.weights.device, dtype=dtype).contiguous()


def node_coords(sol):
    """The node coordinates, each broadcast to the state shape without its
    var axis (float64 NumPy)."""
    import numpy as np

    va = sol.var_axis
    no_var = sol.state_shape[:va] + sol.state_shape[va + 1:]
    return [np.broadcast_to(np.squeeze(c, va), no_var) for c in sol.nodes_meshgrid()]


def tgv_fields(sol):
    """The Taylor–Green vortex (DeBonis, NASA TM-2013-217850, eq. 1–4) on
    the unit box, x/L = 2πx: u = V0 sin cos cos, v = −V0 cos sin cos, w =
    0, p = p0 + ρ0V0²/16 (cos 2x/L + cos 2y/L)(cos 2z/L + 2), ρ = ρ0 p/p0."""
    import numpy as np

    x, y, z = (c / TGV_L for c in node_coords(sol))
    u = np.sin(x) * np.cos(y) * np.cos(z)
    v = -np.cos(x) * np.sin(y) * np.cos(z)
    p = TGV_P0 + (np.cos(2 * x) + np.cos(2 * y)) * (np.cos(2 * z) + 2.0) / 16.0
    return p / TGV_P0, [u, v, np.zeros_like(u)], p


def random_ns_fields(sol, seed=0):
    """Random admissible ρ, velocity and p at every node: every gradient
    of the state is of order 1/dx."""
    import numpy as np

    rng = np.random.default_rng(seed)
    no_var = node_coords(sol)[0].shape
    rho = 1.0 + 0.2 * rng.random(no_var)
    vel = [0.3 * rng.standard_normal(no_var) for _ in range(3)]
    return rho, vel, 1.0 + 0.2 * rng.random(no_var)


def kinetic_energy(torch, sol, u) -> float:
    """∫ ½|m|²/ρ over the box by the solver's quadrature, in float64."""
    q = u.double()
    ke = 0.5 * (q[:, :, :, 1] ** 2 + q[:, :, :, 2] ** 2 + q[:, :, :, 3] ** 2) / q[:, :, :, 0]
    return float(sol.total_mass(ke.unsqueeze(3))[0])


def plain_visc_fluxes(torch, sol, faces, fvwall):
    """The plain version of the Navier–Stokes face flux kernel: each axis's
    F̂ (``interface_flux``) and each wall axis's low-wall fluxes, with the
    viscous wall split when ``fvwall`` is given."""
    fshape = sol.face_flux_shape
    rows = sol.visc_wall_rows(fvwall) if fvwall is not None else {}
    fhat, low = [], {}
    for d in range(3):
        q_lo, q_hi, f_lo, f_hi = (faces[d, k].reshape(fshape) for k in range(4))
        fv_lo, fv_hi = rows.get(d, (None, None))
        fhat.append(sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d, fv_hi))
        if sol.is_wall(d):
            low[d] = sol.low_wall_flux(q_lo, f_lo, d, fv_lo)
    return fhat, low


def fvwall_f64(torch, sol, u, dt, mu, prandtl, walls) -> dict:
    """``{d: (fv_lo, fv_hi)}``: the viscous-only wall planes of ``sol`` on
    ``u`` by the plain predictor in float64.  The predictor is cell-local,
    so a solver on the two cell rows at axis d's walls (the same dx) gives
    axis d's planes, at 2/g_d of the whole grid's cost."""
    rows = {}
    dx = tuple(1.0 / g for g in sol.grid_shape)
    for d in sol.wall_planes():
        g = sol.grid_shape[d]
        grid = tuple(2 if a == d else n for a, n in enumerate(sol.grid_shape))
        slab, _ = ns_solver(torch, u.device, grid, torch.float64, mu=mu, prandtl=prandtl,
                            walls=walls, dx=dx)
        rows_of = u.index_select(sol.grid_axis(d), torch.tensor([0, g - 1], device=u.device))
        rows[d] = slab.visc_wall_rows(slab.predictor_volume(rows_of.double(), dt)[2])[d]
    return rows


def fvwall_f32_check(torch, sol, got, ref, fv64) -> tuple[float, float, str]:
    """The float32 kernel's wall planes ``got`` against ``fv64``
    (:func:`fvwall_f64`): ``(error, limit, why)``, the limit
    ``FVWALL_F32_FACTOR`` times the plain float32 planes' (``ref``) own
    distance from ``fv64``.  Fails when that limit would pass a kernel that
    wrote no viscous split (a tenth of the planes' largest value)."""
    k, p = sol.visc_wall_rows(got), sol.visc_wall_rows(ref)
    pairs = [(k[d][s], p[d][s], fv64[d][s]) for d in fv64 for s in (0, 1)]
    err = max(max_err(torch, a, c) for a, _, c in pairs)
    plain = max(max_err(torch, b, c) for _, b, c in pairs)
    scale = max(c.abs().max().item() for *_, c in pairs)
    limit = max(FVWALL_F32_FACTOR * plain, F32_ULPS * 2.0**-23 * scale)
    why = (f"against plain f64; {FVWALL_F32_FACTOR}x plain f32's {plain:.3e}, "
           f"max|fvwall| {scale:.3e}")
    if not limit < 0.1 * scale:
        fail(f"the f32 wall planes' limit {limit:.3e} cannot tell a kernel that drops the "
             f"viscous split (max|fvwall| {scale:.3e})")
    return err, limit, why


def visc_parity(torch, sol, cu, u, dt, label: str, fv64=None) -> dict:
    """The viscous kernels against the plain solver on ``u``: the
    predictor's outputs (new, faces and with walls the viscous-only wall
    planes), the face flux kernel's F̂ of every axis and low-wall fluxes
    (from the plain faces), the update, the stage and the step.  atol 1e-12
    in float64, ``F32_ULPS`` spacings of the largest plain value in float32;
    the float32 wall planes against ``fv64`` (:func:`fvwall_f32_check`).
    Fails on a disagreement; returns the largest error of each kernel."""
    f64 = u.dtype == torch.float64
    rule = "atol" if f64 else f"{F32_ULPS} f32 spacings of max|plain|"
    fshape = sol.face_flux_shape
    got = cu.predictor_volume(u, dt)
    ref = sol.predictor_volume(u, dt)
    new, faces, fvwall = ref
    fhat_k, fwall_k = cu.face_flux(faces, fvwall)
    fhat_p, wall_p = plain_visc_fluxes(torch, sol, faces, fvwall)
    fwall_p = torch.cat([wall_p[d].reshape(-1) for d in sorted(wall_p)]) if wall_p else None
    upd_k = cu.surface_update(new.clone(), torch.stack(fhat_p).view(fhat_k.shape), dt, fwall_p)
    upd_p = plain_surface_update(sol, new, torch.stack(fhat_p), dt, wall_p)
    stage_k = cu.face_surface(new.clone(), faces, dt, fvwall=fvwall)
    stage_p = sol.face_surface(new, faces, dt, fvwall=fvwall)
    step_k, step_p = cu.step(u, dt), sol.step(u, dt)
    torch.cuda.synchronize()
    pred, flux, update = cu.kernels
    checks = [(pred, what, a, b) for what, a, b in zip(("new", "faces", "fvwall"), got, ref)]
    checks += [(flux, f"fhat[{d}]", fhat_k[d].view(fshape), fhat_p[d]) for d in range(3)]
    checks += [(flux, f"fwall[{d}]", cu.wall_fluxes(fwall_k)[d], wall_p[d]) for d in wall_p]
    checks += [(update, "new", upd_k, upd_p), ("face stage", "new", stage_k, stage_p),
               ("step", "new", step_k, step_p)]
    errs = {}
    for name, what, a, b in checks:
        if what == "fvwall" and b is None:
            continue
        err = max_err(torch, a, b)
        limit, why = (F64_ATOL, rule) if f64 else (f32_bound(torch, b), rule)
        if what == "fvwall" and not f64:
            # The viscous-only flux is a small difference of large terms (the
            # temperature gradient from E ≈ 180 at Mach 0.1): float32 rounds
            # it at ~1e-5 of its size on the plain path too.
            err, limit, why = fvwall_f32_check(torch, sol, a, b, fv64)
        ok = err <= limit
        say(f"[visc parity] {label}: {name} ({what}) {str(u.dtype)[6:]} {sol.grid_shape}: "
            f"max_abs_err {err:.3e} limit {limit:.3e} ({why}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"viscous {name} ({what}) disagrees with its plain version ({label}, "
                 f"{u.dtype}, {sol.grid_shape})")
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


def decay_rate(torch, cu, u0, component: int, t_end: float) -> tuple[float, int]:
    """The measured decay rate of the rms of velocity ``component`` from
    ``u0`` over ``t_end`` (whole steps at cfl_dt), and the step count."""
    dt = float(cu.cfl_dt(u0))
    n = max(1, round(t_end / dt))
    u = cu.run(u0, n, dt)

    def rms(q):
        v = q[:, :, :, 1 + component] / q[:, :, :, 0]
        return float(torch.sqrt((v * v).mean()))

    return math.log(rms(u0) / rms(u)) / (n * dt), n


def timed_once(torch, fn):
    """``(fn(), ms)``: one call of ``fn`` and its device time (CUDA events;
    no warm-up: for the plain path, whose first call here is not its
    first)."""
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def once_ms(torch, fn) -> float:
    """Device time of one call of ``fn`` (:func:`timed_once`)."""
    return timed_once(torch, fn)[1]


def viscous_path(torch, dev, card) -> list[dict]:
    """The viscous path: compressible Navier–Stokes through ``CudaADERDG``.
    The kernels against plain in float64 (periodic, no-slip and outflow
    walls on the cut grid) and float32 (full width); the Taylor–Green vortex
    at ``(64, 64, 64)``, periodic and with no-slip walls, 10 steps at
    ``cfl_dt`` with its checks and times; the decay anchors in float64.
    Returns the kernel JSON lines of the viscous predictor and the
    Navier–Stokes face stage, periodic and walled."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

    # ---------------------------------- 3. f64 kernel vs plain, cut grid
    for walls in (False, "noslip", "outflow"):
        sol, cu = ns_solver(torch, dev, NS_CUT, torch.float64, walls=walls)
        u = ns_state(torch, sol, torch.float64, random_ns_fields(sol))
        visc_parity(torch, sol, cu, u, float(sol.cfl_dt(u)),
                    f"Navier–Stokes {walls or 'periodic'}")
    del sol, cu, u

    gib = 2.0**-30
    lines, replaces = [], "exahype_tpu/models/aderdg_pallas.py:156"
    visc_src = "exahype_tpu_torch/csrc/aderdg_visc.cu"
    dofs = math.prod(NS_GRID) * (ORDER + 1) ** 3 * 5
    ncell = math.prod(NS_GRID)
    runs = {}
    for walls in (False, "noslip"):
        label = "periodic" if not walls else "no-slip walls on axis 0"
        sol, cu = ns_solver(torch, dev, NS_GRID, torch.float32, mu=TGV_MU,
                            prandtl=TGV_PRANDTL, walls=walls)
        u0 = ns_state(torch, sol, torch.float32, tgv_fields(sol))
        dt = float(cu.cfl_dt(u0))
        say(f"[visc] Taylor–Green vortex {NS_GRID} f32, {label}: μ = {TGV_MU!r}, Pr = "
            f"{TGV_PRANDTL}, p0 = {TGV_P0!r}; dt = cfl_dt = {dt!r} (the parabolic term "
            "included)")
        # ------------------------------ f32 kernel vs plain, full width
        fv64 = fvwall_f64(torch, sol, u0, dt, TGV_MU, TGV_PRANDTL, walls) if walls else None
        errs = visc_parity(torch, sol, cu, u0, dt, f"Taylor–Green {label}", fv64)

        # ------------------------------ 4. the main path, 10 steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cu.reset_launches()
        u, ke = u0, [kinetic_energy(torch, sol, u0)]
        for _ in range(STEPS):
            u = cu.step(u, dt)
            ke.append(kinetic_energy(torch, sol, u))
        torch.cuda.synchronize()
        launches = dict(cu.launches)
        say(f"[visc mem] kernel path, {STEPS} steps: peak "
            f"{torch.cuda.max_memory_allocated() * gib:.4f} GiB allocated ({held * gib:.4f} "
            f"GiB held before) ({card})")
        say(f"[visc main] {label}: {STEPS} steps through CudaADERDG: launches {launches}")
        if launches != {name: STEPS for name in cu.kernels}:
            fail(f"the viscous step launched {launches} in {STEPS} steps, expected 3 a step")
        if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
            fail(f"the viscous state ({label}) is not finite or has the wrong shape")
        m0, m1 = cu.total_mass(u0.double()), cu.total_mass(u.double())
        rel = ((m1 - m0).abs() / m0.abs()).tolist()
        moved = ((m1 - m0).abs()[1:4] / m0[0].abs()).tolist()
        steps_down = all(b < a for a, b in zip(ke, ke[1:]))
        decay = 1.0 - ke[-1] / ke[0]
        exact = -math.expm1(-2.0 * TGV_MU * TGV_K2 * STEPS * dt)
        say(f"[visc main] {label}: relative change over {STEPS} steps: mass {rel[0]:.3e}, "
            f"energy {rel[4]:.3e} (limit {MASS_RTOL:.1e}); momentum moved by {moved[0]:.3e}, "
            f"{moved[1]:.3e}, {moved[2]:.3e} of the mass; kinetic energy {ke[0]!r} -> "
            f"{ke[-1]!r} (decay {decay!r}), down at every step {steps_down}")
        if not rel[0] <= MASS_RTOL:
            fail(f"the viscous step ({label}) does not conserve mass")
        if not walls and not (rel[4] <= MASS_RTOL and max(moved) <= MASS_RTOL and steps_down):
            fail("the periodic vortex does not conserve energy or momentum, or its kinetic "
                 "energy did not decrease at every step")
        if not walls:
            say(f"[visc main] periodic: kinetic-energy decay {decay!r} against the viscous "
                f"rate's 1 − exp(−2ν|k|²t) = {exact!r}, relative error "
                f"{abs(decay - exact) / exact:.3e} (limit {NS_ANCHOR_RTOL})")
            if not abs(decay - exact) / exact < NS_ANCHOR_RTOL:
                fail("the periodic vortex's kinetic energy does not decay at 2ν|k|²")
        if walls and not ke[-1] < ke[0]:
            fail("the walled vortex's kinetic energy did not decrease")
        if not torch.equal(u, cu.run(u0, STEPS, dt)):
            fail(f"two runs of the viscous step ({label}) differ")
        say(f"[visc main] {label}: two runs from the same state: bitwise equal")

        # ------------------------------ 5. times and readings
        new, faces, fv = cu.predictor_volume(u0, dt)
        fhat, fwall = cu.face_flux(faces, fv)
        walls_of = {} if fwall is None else cu.wall_fluxes(fwall)
        pred, flux, update = cu.kernels
        times = {
            pred: (event_ms(torch, lambda: cu.predictor_volume(u0, dt), 20),
                   once_ms(torch, lambda: sol.predictor_volume(u0, dt))),
            "face stage": (event_ms(torch, lambda: cu.face_surface(new, faces, dt, fvwall=fv), 20),
                           once_ms(torch, lambda: sol.face_surface(new, faces, dt, fvwall=fv))),
            flux: (event_ms(torch, lambda: cu.face_flux(faces, fv), 20),
                   once_ms(torch, lambda: plain_visc_fluxes(torch, sol, faces, fv))),
            update: (event_ms(torch, lambda: cu.surface_update(new, fhat, dt, fwall), 20),
                     once_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt, walls_of))),
        }
        plain_step_ms = once_ms(torch, lambda: sol.step(u0, dt))
        for name, (ms, plain_ms) in times.items():
            say(f"[visc time] {name} ({label}): kernel {ms!r} ms, plain {plain_ms!r} ms (CUDA "
                f"events; {card})")
        if not walls:
            # The Euler face stage on the same faces, in the same run.
            esol = ADERDGSolver(3, ORDER, 5, NS_GRID, *euler_physics(3), dx=1.0 / NS_GRID[0],
                                device=dev, dtype=torch.float32)
            ecu = CudaADERDG(esol)
            euler_ms = event_ms(torch, lambda: ecu.face_surface(new, faces, dt), 20)
            say(f"[visc time] Euler face stage on the same faces: {euler_ms!r} ms; "
                f"Navier–Stokes {times['face stage'][0]!r} ms "
                f"({times['face stage'][0] / euler_ms - 1.0:+.3%}) ({card})")
            del esol, ecu
        idle, busy, wall = idle_share(torch, lambda: cu.run(u0, 20, dt))
        say(f"[visc idle] {label}, 20 steps under torch.profiler: device busy {busy!r} ms of "
            f"wall {wall!r} ms; idle share {idle!r} ({card})")
        itemsize = u0.element_size()
        side = 0 if fv is None else cu.walls["size"] * itemsize
        low = 0 if fv is None else cu.walls["size"] // 5
        face_bytes, state_bytes = faces.nbytes, u0.nbytes
        split = fv is not None
        pen_ops = ncell * 3 * 16 * NS_PENALTY_OPS + low * (2 * EIG_OPS + 6 * 5 + NS_PENALTY_OPS)
        work = {
            pred: (2 * state_bytes + face_bytes + 2 * side,
                   visc_predictor_ops(ORDER, sol.picard_iters, ncell, split)),
            flux: (face_flux_bytes(ORDER, ncell, itemsize) + side + 2 * side,
                   face_flux_ops(ORDER, ncell) + pen_ops),
            update: (surface_update_bytes(ORDER, ncell, itemsize) + side,
                     surface_update_ops(ORDER, ncell)),
            "face stage": (face_stage_bytes(ORDER, ncell, itemsize) + 3 * side,
                           face_surface_ops(ORDER, ncell) + pen_ops),
        }
        tag = "Navier–Stokes" + ("" if not walls else ", no-slip walls")
        for name in (pred, flux, update, "face stage"):
            bnd = kernel_report(None if name == "face stage" else cu, name, torch.float32,
                                f"({tag}) {NS_GRID} f32", times[name][0], *work[name], card)
            count = launches[update if name == "face stage" else name]
            title = (f"{flux} + {update} (face stage, {tag})" if name == "face stage"
                     else f"{name} ({tag})")
            lines.append(kernel_line(title, replaces, count, errs[name], *times[name], bnd,
                                     visc_src if name == pred else
                                     "exahype_tpu_torch/csrc/aderdg.cu"))
        wins = windows(torch, cu, u0, dt, steps=10)
        runs[label] = wins
        ms = [1e3 * w for w in wins]
        say(f"[visc time] {label} step: step ms per window {ms!r}; median "
            f"{statistics.median(ms)!r} ms, {dofs / statistics.median(wins)!r} DOF-updates/s; "
            f"plain step {plain_step_ms!r} ms ({card})")
        del sol, cu, u0, u, new, faces, fhat, fwall, fv, walls_of
        torch.cuda.empty_cache()
    periodic, walled = (statistics.median(w) for w in runs.values())
    say(f"[visc time] the walled step against the periodic one, same run: {1e3 * walled!r} ms "
        f"against {1e3 * periodic!r} ms ({walled / periodic - 1.0:+.3%}) ({card})")

    # ---------------------------------- 6. the decay anchors, float64
    mu_shear, mu_channel, V = 0.02, 0.01, 1e-3
    sol, cu = ns_solver(torch, dev, (16, 4, 4), torch.float64, mu=mu_shear)
    x = node_coords(sol)[0]
    zero = np.zeros_like(x)
    u0 = ns_state(torch, sol, torch.float64,
                  (np.ones_like(x), [zero, zero, V * np.sin(2 * np.pi * x)], np.ones_like(x)))
    rate, n = decay_rate(torch, cu, u0, 2, 0.1)
    exact = mu_shear * (2 * np.pi) ** 2
    say(f"[visc anchor] shear mode v_z = {V} sin(2πx), μ = {mu_shear}, (16, 4, 4) p3 f64 through "
        f"CudaADERDG, {n} steps: decay rate {rate!r}, exact ν(2π)² = {exact!r}, relative "
        f"error {abs(rate - exact) / exact:.3e} (limit {NS_ANCHOR_RTOL})")
    if not abs(rate - exact) / exact < NS_ANCHOR_RTOL:
        fail("the shear mode does not decay at ν(2π)²")
    sol, cu = ns_solver(torch, dev, (8, 4, 4), torch.float64, mu=mu_channel, walls="noslip")
    x = node_coords(sol)[0]
    zero = np.zeros_like(x)
    u0 = ns_state(torch, sol, torch.float64,
                  (np.ones_like(x), [zero, V * np.sin(np.pi * x), zero], np.ones_like(x)))
    rate, n = decay_rate(torch, cu, u0, 1, 1.0)
    exact = mu_channel * np.pi**2
    say(f"[visc anchor] no-slip channel mode v_y = {V} sin(πx), μ = {mu_channel}, walls on "
        f"axis 0, (8, 4, 4) p3 f64 through CudaADERDG, {n} steps: decay rate {rate!r}, exact "
        f"νπ² = {exact!r}, relative error {abs(rate - exact) / exact:.3e} (limit "
        f"{NS_ANCHOR_RTOL})")
    if not abs(rate - exact) / exact < NS_ANCHOR_RTOL:
        fail("the no-slip channel mode does not decay at νπ²")
    say(f"[visc mem] peak allocated so far {torch.cuda.max_memory_allocated() * gib:.4f} GiB")
    del sol, cu, u0
    torch.cuda.empty_cache()
    return lines


def z4_tally(torch, rhs_all, q, grads, skip_zero: bool = False) -> dict:
    """The elementwise arithmetic ops (+, −, ×, ÷, negation, reciprocal, √)
    of one evaluation of the plain algebra ``rhs_all(q, grads, 0)``, by kind,
    under a dispatch mode that tallies them; with ``skip_zero`` not the
    products with an all-zero operand nor the sums with one, which need no
    work.  The algebra has no branch, so a count holds for every point
    alike."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt"}
    counts = {}

    def zero(x):
        return (isinstance(x, torch.Tensor) and not bool(x.any())) or (
            isinstance(x, (int, float)) and x == 0)

    class Tally(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in arith and not (skip_zero and name in ("mul", "add", "sub", "rsub")
                                      and any(zero(a) for a in args[:2])):
                counts[name] = counts.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Tally():
        rhs_all(q, grads, 0)
    return counts


def z4_base(torch, n: int, points: int):
    """``points`` float64 CPU points of flat space, ``[n, points]``: α = 1,
    γ = identity; with the Z4+GRHD system's 43 variables also a fluid at
    rest (D̃ = 0.02, τ̃ = 0.008), with the Z4+GRMHD system's 47 a magnetized
    one (ρ = p = 1, B^x = 0.05: D̃ = 1, τ̃ = 1.50125), so that the recovery is
    finite."""
    q = torch.zeros(n, points, dtype=torch.float64)
    q[[0, 1, 4, 6]] = 1.0
    if n == 43:
        q[38], q[42] = 0.02, 0.008
    if n == 47:
        q[38], q[42], q[43] = 1.0, 1.50125, 0.05
    return q


def z4_point_ops(torch, rhs_all) -> dict:
    """The arithmetic of K5's plain version at one point, by kind
    (:func:`z4_tally` on one float64 CPU point of flat space, zero
    gradients, every op counted); the system's variables from its tag (38,
    53 shifted, 43 Z4+GRHD or 47 Z4+GRMHD, its fluid at rest)."""
    n = rhs_all.physics.n_real
    q = z4_base(torch, n, 1)
    grads = tuple(torch.zeros(n, 1, dtype=torch.float64) for _ in range(3))
    return z4_tally(torch, rhs_all, q, grads)


def z4_slots_read(torch, rhs_all) -> tuple[int, int]:
    """``(state slots, gradient slots of the three directions together)``
    that K5's plain version reads: one evaluation of the plain algebra on
    float64 CPU points of flat space, point p holding NaN in one input slot
    (state slot p, then each direction's n gradient slots, n the system's
    variables).  A slot is read when its NaN reaches the output: the algebra
    has no branch, and NaN·0 is NaN."""
    n = rhs_all.physics.n_real
    q = z4_base(torch, n, 4 * n)
    grads = tuple(torch.zeros(n, 4 * n, dtype=torch.float64) for _ in range(3))
    for slot in range(n):
        q[slot, slot] = math.nan
        for k, gq in enumerate(grads):
            gq[slot, (k + 1) * n + slot] = math.nan
    reached = torch.isnan(rhs_all(q, grads, 0)).any(dim=0)
    return int(reached[:n].sum()), int(reached[n:].sum())


def z4_value_point(torch, n: int, grad_axes):
    """``(q, grads)``: one float64 CPU point of ``n`` variables whose state
    has no zero slot (α, γ near flat space; with a fluid, one that recovers)
    and whose gradient is seeded noise along ``grad_axes`` and zero along
    the other axes."""
    import numpy as np

    rng = np.random.default_rng(11)
    q = torch.from_numpy(0.1 * rng.standard_normal((n, 1)))
    q[[0, 1, 4, 6]] += 1.0
    if n in (43, 47):
        q[38:] = 0.01 * q[38:] + z4_base(torch, n, 1)[38:]
    grads = tuple(torch.from_numpy(rng.standard_normal((n, 1))) if k in grad_axes
                  else torch.zeros(n, 1, dtype=torch.float64) for k in range(3))
    return q, grads


def z4_value_ops(torch, rhs_all, grad_axes=(0, 1, 2)) -> int:
    """The arithmetic one evaluation of the algebra needs at a point whose
    state has no zero slot and whose gradient is nonzero along
    ``grad_axes`` only (:func:`z4_value_point`): :func:`z4_tally` with
    ``skip_zero`` (the kernels of ``csrc/aderdg_z4.cuh`` compile the zero
    gradient rows' terms away where they know them at compile time)."""
    q, grads = z4_value_point(torch, rhs_all.physics.n_real, grad_axes)
    return sum(z4_tally(torch, rhs_all, q, grads, skip_zero=True).values())


def z4_ncp_ops(torch, rhs_all, axis: int) -> int:
    """The arithmetic that the non-conservative product B_axis(q)·Δq alone
    needs at a point (:func:`z4_value_point` with the gradient along
    ``axis``): the algebra, affine in the gradient, is traced op by op under
    a dispatch mode, and only the work of the difference rhs(q, e_axis Δq) −
    rhs(q, 0) is counted.  That is each op on a value that depends on the
    gradient (a sum of such a value and a gradient-free one costs nothing:
    the gradient-free term cancels), plus every gradient-free op that a
    coefficient of such an op needs (a factor or divisor, and what computes
    it, each counted once).  Ops are counted as :func:`z4_tally` with
    ``skip_zero`` counts them; an op other than a sum, product, quotient by
    a gradient-free value, negation or a data movement on a gradient-
    dependent value raises."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    arith = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt"}
    moves = {"select", "slice", "stack", "cat", "permute", "view", "unsqueeze", "squeeze",
             "expand", "clone", "alias", "transpose", "t", "detach", "_unsafe_view"}
    # A record per op: [cost, depends on the gradient, the inputs whose δ it
    # reads, the gradient-free inputs it needs whole]; nodes[i] is the record
    # of value i (several outputs of one op share it).
    nodes, key, keep = [], {}, []

    def value(t, rec):
        key[id(t)] = len(nodes)
        keep.append(t)  # keeps every id() unique while the trace lives
        nodes.append(rec)

    def zero(x):
        return (isinstance(x, torch.Tensor) and not bool(x.any())) or (
            isinstance(x, (int, float)) and x == 0)

    class Flow(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            ins = []
            for t in tree_leaves((args, kwargs or {})):
                if isinstance(t, torch.Tensor):
                    if id(t) not in key:
                        value(t, [0, False, [], []])  # a constant
                    ins.append(key[id(t)])
            cost = int(name in arith and not (name in ("mul", "add", "sub", "rsub")
                                              and any(zero(a) for a in args[:2])))
            dep = [i for i in ins if nodes[i][1]]
            free = [i for i in ins if not nodes[i][1]]
            outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
            if dep and not any(bool(o.any()) for o in outs):
                rec = [0, False, [], []]  # a zero: the same in both evaluations
            elif not dep:
                rec = [cost, False, [], free]
            elif name in ("add", "sub", "rsub"):
                rec = [cost if len(dep) == 2 else 0, True, dep, []]
            elif name == "neg" or (name == "mul" and len(dep) == 1) or (
                    name == "div" and dep == [key.get(id(args[0]))]):
                rec = [cost, True, dep, free]
            elif name in moves:
                rec = [0, True, dep, []]
            else:
                raise ValueError(f"{name} of the gradient: the algebra is not affine in it")
            for o in outs:
                value(o, rec)
            return out

    q, grads = z4_value_point(torch, rhs_all.physics.n_real, (axis,))
    value(q, [0, False, [], []])
    for k, gq in enumerate(grads):
        value(gq, [0, k == axis, [], []])
    with Flow():
        r = rhs_all(q, grads, 0)
    # Back from the output: the δ ops it reads, then the coefficients'
    # whole gradient-free cones.
    need_dep, need_free, todo = set(), set(), [key[id(r)]]
    while todo:
        i = todo.pop()
        if i not in need_dep:
            need_dep.add(i)
            todo += nodes[i][2]
            need_free.update(nodes[i][3])
    todo = list(need_free)
    while todo:
        for j in nodes[todo.pop()][3]:
            if j not in need_free:
                need_free.add(j)
                todo.append(j)
    recs = {id(nodes[i]): nodes[i] for i in need_dep | need_free}
    return sum(rec[0] for rec in recs.values())


def z4_kernel_work(order: int, picard_iters: int, ncell: int, itemsize: int, full: int,
                   zero: int, one_axis: int, v: int = 38, gs: int = 31, eig_ops: int = 23,
                   suffix: str = "z4", hydro: int = 0, flux_ops: int = 0, dim: int = 3,
                   ncp: int | None = None, names: tuple | None = None) -> dict:
    """``{kernel: (bytes, operations)}`` of the Z4 step's three kernels
    (``csrc/aderdg_z4.cuh``; ``suffix`` "z4", "z4_shift", "z4_matter" or
    "z4_grmhd"), from the
    algebra's operations at a point (``full``: every gradient axis;
    ``zero``: none; ``one_axis``: one, averaged over the axes;
    :func:`z4_value_ops`), the system's ``v`` variables and the ``gs``
    slots an axis whose gradients its algebra reads (:func:`z4_slots_read`:
    38 and 31; shifted, 53 and 43 for the Gamma-driver, 40 frozen).  Per
    cell, N = 3, 81 space-time points and 27 nodes:

    - predictor: ``picard_iters`` x 81 full evaluations, 81 zero ones (s̄),
      27 full and 27 zero ones (the NCP volume term); per iteration the 3 gs
      gradients of each point (3-point contraction and a product, 6 ops),
      its v right-hand sides (3) and K1inv (5 a slot, slice and node);
      q̄, s̄ and new (5 each a node and slot, new 5 more); ∇q̄ (6); the face
      projections (2 x 5 a face node, slot and axis).  Bytes: u read, new
      and the face tensor written.
    - face flux: per face node of each axis (27 a cell), 2 wave speeds
      (``eig_ops`` each: the cofactors, determinant, division, slicing and
      root, 23; shifted |β^d| and a sum more), their max, per slot Δq, F̂
      (2), q̃ (2) and the half (2), a zero and a one-axis evaluation.
      Bytes: both faces' v slots read, F̂ and the half written.
    - update: per node, slot and axis 10 (two λ(φ1/w a ∓ φ0/w b) terms).
      Bytes: the state read and written, F̂ and the halves read.

    With a conservative flux on ``hydro`` rows (Z4+GRHD: 5, Z4+GRMHD: 9;
    their ``dim`` axes' rows cost ``flux_ops`` at a point beside the recovery
    the algebra's count holds): per iteration and point the flux and its D·F terms (a
    3-point contraction, the λ w product and the difference: 7 a row and
    axis); in the epilogue the flux at every point, F̄ (5 a row, axis and
    node), the volume term (a contraction, λ and the sum: 8) and F̄'s face
    projections (2 x 5); in the face flux kernel ½(f_hi + f⁺) (2 more a
    hydro row) and those rows of both faces read.

    On a ``dim``-dimensional cell the counts are its own (n^(dim+1) points,
    n^dim nodes, dim n^(dim-1) face nodes, dim gradient axes).  The per-axis
    branch (``ncp``: the operations of the dim NCP products B_d·Δq at a
    point together, :func:`z4_ncp_ops`) evaluates, per iteration and point,
    the source (``zero``) and each axis's product in place of one full
    evaluation, and per node the products for the NCP volume term in place
    of the fused pair; its right-hand sides cost 3 dim + 2 a slot, its new
    state 3 a slot and axis more.  ``names``: the three kernels' names, if
    not the suffix's."""
    n = order + 1
    pts, nodes, fn = n ** (dim + 1), n**dim, dim * n ** (dim - 1)
    point = full if ncp is None else zero + ncp
    rhs = 3 if ncp is None else 3 * dim + 2
    volume = full + zero if ncp is None else ncp
    new_ops = 20 if ncp is None else 15 + 3 * dim
    pred_ops = (picard_iters * (pts * point + pts * dim * gs * 6 + pts * v * rhs
                                + nodes * v * n * 5)
                + pts * zero + nodes * volume + nodes * v * new_ops + nodes * dim * gs * 6
                + fn * v * 2 * 5)
    pred_ops += (picard_iters * pts * (flux_ops + hydro * dim * 7) + pts * flux_ops
                 + nodes * hydro * dim * (5 + 8) + fn * hydro * 2 * 5)
    flux_ops = fn * (2 * eig_ops + 1 + v * 7 + zero + one_axis + 2 * hydro)
    update_ops = nodes * v * dim * 10
    names = names or tuple(f"aderdg_{k}_{suffix}"
                           for k in ("predictor_volume", "face_flux", "surface_update"))
    return dict(zip(names, (
        (ncell * itemsize * (2 * nodes * v + 4 * fn * v), ncell * pred_ops),
        (ncell * itemsize * fn * (4 * v + 2 * hydro), ncell * flux_ops),
        (ncell * itemsize * (2 * nodes * v + 2 * fn * v), ncell * update_ops))))


def z4_plain_face_flux(torch, sol, faces):
    """The plain versions of the Z4 face flux kernel's two outputs, ``fhat``
    (``interface_flux``) and ``fhalf`` (``ncp_half``), in its layout
    ``[dim, n^(dim-1), V, *grid]``."""
    fs = sol.face_flux_shape
    dim = sol.dim
    parts = [[faces[d, k].reshape(fs) for k in range(4)] for d in range(dim)]
    shape = (dim, -1) + tuple(fs[-1 - dim:])
    return (torch.stack([sol.interface_flux(*parts[d], d) for d in range(dim)]).reshape(shape),
            torch.stack([sol.ncp_half(*parts[d], d) for d in range(dim)]).reshape(shape))


def z4_plain_update(sol, new, fhat, fhalf, dt):
    """The plain version of the Z4 update kernel (a new tensor): each axis's
    surface term, then its NCP term."""
    fs = sol.face_flux_shape
    for d in range(sol.dim):
        new = sol.surface_term(new, fhat[d].view(fs), d, dt)
        new = sol.ncp_term(new, fhalf[d].view(fs), d, dt)
    return new


def z4_kernel_parity(torch, sol, cu, u, dt, label: str, sol64=None, tag: str = "z4",
                     plain_ms=None) -> dict:
    """The Z4 step's three kernels against their plain versions on ``u``:
    the predictor's new state and faces; the face flux kernel's F̂ and NCP
    halves from the plain faces; the update from the plain fluxes; the face
    stage and the step (the plain step is the plain predictor's and face
    stage's results, which are its two halves; the plain face stage is
    ``ADERDGSolver.face_surface`` in float64, and in float32, at full width,
    the plain face flux's and update's results, the same interface fluxes,
    NCP halves and terms axis by axis).  With ``plain_ms`` (a dict) it also
    times each plain version as it runs (CUDA events, one call) into it, by
    the kernel's name (and the plain face stage as "face stage": in float32
    the flux's and the update's times).
    float64: 1e-12 of max(1, max|plain|); float32: ``F32_ULPS`` spacings of
    max|plain|, but the NCP halves, a difference of two evaluations of the
    algebra (~25 each) that cancels to ~1e-2, against the plain path in float64
    from the same faces (``sol64``, the solver in float64), to
    ``FVWALL_F32_FACTOR`` times the plain float32 halves' own distance, as the
    viscous wall planes. Fails on a disagreement; returns the largest error of
    each kernel. ``tag`` prefixes the printed lines."""
    f64 = u.dtype == torch.float64
    pred, flux, update = cu.kernels
    times = {} if plain_ms is None else plain_ms

    def plain(name, fn):
        out, times[name] = timed_once(torch, fn)
        return out

    new_k, faces_k, _ = cu.predictor_volume(u, dt)
    new_p, faces_p, _ = plain(pred, lambda: sol.predictor_volume(u, dt))
    fhat_k, fhalf_k = cu.face_flux(faces_p)
    fhat_p, fhalf_p = plain(flux, lambda: z4_plain_face_flux(torch, sol, faces_p))
    fhat_p, fhalf_p = fhat_p.contiguous(), fhalf_p.contiguous()
    upd_k = cu.surface_update(new_p.clone(), fhat_p, dt, fhalf=fhalf_p)
    upd_p = plain(update, lambda: z4_plain_update(sol, new_p, fhat_p, fhalf_p, dt))
    stage_k = cu.face_surface(new_p.clone(), faces_p, dt)
    if f64:  # the cut grids: the solver's own face stage, an independent reference
        stage_p = plain("face stage", lambda: sol.face_surface(new_p, faces_p, dt))
    else:
        stage_p, times["face stage"] = upd_p, times[flux] + times[update]
    step_k, step_p = cu.step(u, dt), stage_p
    torch.cuda.synchronize()
    # The F̄ rows are zero but on the coupled systems' matter rows (38 on).
    coupled = sol.n_vars in (43, 47)
    if faces_k[:, 2:, :, :38].any() or (not coupled and faces_k[:, 2:].any()):
        fail(f"the Z4 predictor wrote nonzero F̄ rows ({label})")
    if coupled and not faces_k[:, 2:, :, 38:].any():
        fail(f"the coupled Z4 predictor wrote no matter F̄ rows ({label})")
    checks = [(pred, "new", new_k, new_p), (pred, "faces", faces_k, faces_p),
              (flux, "fhat", fhat_k, fhat_p), (flux, "fhalf", fhalf_k, fhalf_p),
              (update, "new", upd_k, upd_p), ("face stage", "new", stage_k, stage_p),
              ("step", "new", step_k, step_p)]
    errs = {}
    for name, what, a, b in checks:
        err = max_err(torch, a, b)
        if f64:
            limit = Z4_F64_RTOL * max(1.0, b.abs().max().item())
            why = f"{Z4_F64_RTOL:.0e} x max(1, max|plain| = {b.abs().max().item():.4g})"
        elif what == "fhalf":
            ref64 = z4_plain_face_flux(torch, sol64, faces_p.double())[1]
            err, plain = max_err(torch, a, ref64), max_err(torch, b, ref64)
            scale = ref64.abs().max().item()
            limit = max(FVWALL_F32_FACTOR * plain, F32_ULPS * 2.0**-23 * scale)
            why = (f"against plain f64 from the same faces; {FVWALL_F32_FACTOR}x plain f32's "
                   f"{plain:.3e}, max|fhalf| {scale:.3e}")
            if not limit < 0.1 * scale:
                fail(f"the f32 NCP halves' limit {limit:.3e} cannot tell a kernel that drops "
                     f"them (max|fhalf| {scale:.3e})")
            del ref64
        else:
            limit = f32_bound(torch, b)
            why = f"{F32_ULPS} f32 spacings of max|plain| = {b.abs().max().item():.4g}"
        ok = err <= limit
        say(f"[{tag} parity] {label}: {name} ({what}) {str(u.dtype)[6:]} {sol.grid_shape}: "
            f"max_abs_err {err:.3e} limit {limit:.3e} ({why}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"Z4 {name} ({what}) disagrees with its plain version ({label}, {u.dtype}, "
                 f"{sol.grid_shape})")
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


def z4_rhs_calls(sol, u, dt) -> list:
    """The inputs of each ``rhs_all_fn`` call of one plain step of ``sol``
    from ``u``: the Picard iterations' and the corrector's two."""
    calls = []
    rec = copy.copy(sol)

    def record(Q, grads, va):
        calls.append((Q, tuple(grads), va))
        return sol.rhs_all_fn(Q, grads, va)

    rec.rhs_all_fn = record
    rec.step(u, dt)
    return calls


def z4_call_name(i: int, iters: int) -> str:
    return (f"Picard iteration {i + 1}" if i < iters
            else ("corrector rhs_all(q̄, ∇q̄)" if i == iters else "corrector rhs_all(q̄, 0)"))


def z4_path(torch, dev, card) -> list[dict]:
    """The dynamic-GR form of the main path: the Z4 step through
    ``CudaADERDG`` (K1 d, ``csrc/aderdg_z4.cu``), and the ``with_cuda_rhs``
    route (K5); returns their lines of the kernel JSON."""
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import (
        gauge_wave_state,
        make_z4_solver,
        solver_constraints,
    )

    def make(grid, dtype, **params):
        plain = make_z4_solver(3, Z4_ORDER, grid, dx=Z4_DX, impl="soa", fused_rhs="soa",
                               device=dev, dtype=dtype, **params)
        return plain, with_cuda_rhs(plain)

    def k5_inputs(sol, u):
        return z4_rhs_calls(sol, u, Z4_DT)

    call_name = z4_call_name

    # ------------------------------------------- kernels vs plain, float64, cut grid
    for params in Z4_PARAMS:
        plain64, kern64 = make(Z4_CUT, torch.float64, **params)
        k5_64 = kern64.rhs_all_fn
        which = f"{k5_64.inner.physics.params}"
        u = gauge_wave_state(plain64, amplitude=Z4_AMPLITUDE)
        for i, (Q, grads, va) in enumerate(k5_inputs(plain64, u)):
            got, again = k5_64(Q, grads, va), k5_64(Q, grads, va)
            ref = plain64.rhs_all_fn(Q, grads, va)
            torch.cuda.synchronize()
            err = max_err(torch, got, ref)
            limit = Z4_F64_RTOL * max(1.0, ref.abs().max().item())
            ok = err <= limit and torch.equal(got, again)
            say(f"[z4 parity] rhs_all_z4 float64 {Z4_CUT} (slicing, f, m, κ₁, κ₂) = {which} "
                f"{call_name(i, plain64.picard_iters)} {tuple(Q.shape)}: max_abs_err "
                f"{err:.3e} limit {limit:.3e} ({Z4_F64_RTOL:.0e} x max(1, max|plain| = "
                f"{ref.abs().max().item():.4g})); repeat bitwise {torch.equal(got, again)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K5 (float64, {which}, {call_name(i, plain64.picard_iters)}) disagrees "
                     "with its plain version")
        if not params:  # the path's own parameters: a whole step too
            step_k, step_p = kern64.step(u, Z4_DT), plain64.step(u, Z4_DT)
            err = max_err(torch, step_k, step_p)
            limit = Z4_F64_RTOL * max(1.0, step_p.abs().max().item())
            say(f"[z4 parity] one float64 step {Z4_CUT}, kernel path vs plain path: "
                f"max_abs_err {err:.3e} limit {limit:.3e}; K5 launches {k5_64.launches}")
            if not err <= limit:
                fail("the float64 Z4 step through K5 disagrees with the plain step")
            del step_k, step_p
        # K1 d, the same solver through CudaADERDG: each kernel, the stage, a step.
        cu64 = CudaADERDG(plain64)
        z4_kernel_parity(torch, plain64, cu64, u, Z4_DT, f"K1 d {which}")
        del plain64, kern64, k5_64, u, got, again, ref, cu64

    # ------------------------------------------- kernels vs plain, float32, full width
    plain, kern = make(Z4_GRID, torch.float32)
    cu = CudaADERDG(plain)
    k5 = kern.rhs_all_fn
    iters = plain.picard_iters
    u0 = gauge_wave_state(plain, amplitude=Z4_AMPLITUDE)
    ncell = math.prod(Z4_GRID)
    dofs = plain.dofs()
    cfl = float(plain.cfl_dt(u0))
    say(f"[z4] {Z4_GRID} cells, order {Z4_ORDER}, 38 vars: {dofs} DOF, state {u0.nbytes} B "
        f"f32; dt = {Z4_DT!r} (scripts/z4_probe.py:57); cfl_dt(initial state) = {cfl!r} "
        f"(dt = {Z4_DT / cfl:.3f} x cfl_dt); picard_iters {iters}")
    calls = k5_inputs(plain, u0)
    k5_err = 0.0
    for i in (0, iters):  # the first Picard call, the corrector's ∇q̄ call
        Q, grads, va = calls[i]
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        ref64 = plain.rhs_all_fn(Q.double(), tuple(g.double() for g in grads), va)
        torch.cuda.synchronize()
        err, limit = max_err(torch, got, ref), f32_bound(torch, ref)
        to64_k, to64_p = max_err(torch, got, ref64), max_err(torch, ref, ref64)
        ok = err <= limit
        say(f"[z4 parity] rhs_all_z4 float32 {Z4_GRID} {call_name(i, iters)} {tuple(Q.shape)}: "
            f"max_abs_err {err:.3e} limit {limit:.3e} ({F32_ULPS} f32 spacings of max|plain| = "
            f"{ref.abs().max().item():.4g}) {'ok' if ok else 'FAIL'}; against the float64 "
            f"plain result: kernel {to64_k:.3e}, plain float32 {to64_p:.3e}"
            f"{' (the kernel is farther)' if to64_k > to64_p else ''}")
        if not ok:
            fail(f"K5 (float32, {call_name(i, iters)}) disagrees with its plain version")
        k5_err = max(k5_err, err)
        del got, ref, ref64
    pic, cor = calls[0], calls[iters]
    del calls
    sol64, _ = make(Z4_GRID, torch.float64)
    plain_times = {}  # the plain stages' times, as the parity call runs them
    k1d_errs = z4_kernel_parity(torch, plain, cu, u0, Z4_DT, "K1 d, the path's own", sol64,
                                plain_ms=plain_times)
    torch.cuda.empty_cache()

    # ------------------------------------------- the main path: CudaADERDG
    gib = 2.0**-30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cu.reset_launches()
    u_d = cu.run(u0, STEPS, Z4_DT)
    torch.cuda.synchronize()
    d_launches = dict(cu.launches)
    d_peak = torch.cuda.max_memory_allocated()
    say(f"[z4 main] {STEPS} steps of {Z4_GRID} f32 through CudaADERDG(make_z4_solver(..., "
        f"fused_rhs='soa')): launches {d_launches} (expected {STEPS} of each: 3 a step); peak "
        f"{d_peak * gib:.4f} GiB allocated ({held * gib:.4f} GiB held before) ({card})")
    if d_launches != {name: STEPS for name in cu.kernels}:
        fail(f"the Z4 step through CudaADERDG launched {d_launches} in {STEPS} steps, "
             "expected 3 a step")
    if tuple(u_d.shape) != plain.state_shape or not torch.isfinite(u_d).all():
        fail("the Z4 state through CudaADERDG is not finite or has the wrong shape")
    if not torch.equal(u_d, cu.run(u0, STEPS, Z4_DT)):
        fail("two Z4 runs through CudaADERDG from the same state differ")
    say("[z4 main] CudaADERDG: two runs from the same state: bitwise equal")

    # ------------------------------------------- the with_cuda_rhs route (K5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    k5.reset_launches()
    u = kern.run(u0, Z4_EAGER_STEPS, Z4_DT)
    torch.cuda.synchronize()
    launches = k5.launches
    peak = torch.cuda.max_memory_allocated()
    want = (iters + 2) * Z4_EAGER_STEPS
    say(f"[z4 main] {Z4_EAGER_STEPS} steps of {Z4_GRID} f32 through make_z4_solver + with_cuda_rhs: "
        f"K5 launches {launches} (expected (picard_iters + 2) x steps = {want}); peak "
        f"{peak * gib:.4f} GiB allocated ({held * gib:.4f} GiB held before: the first "
        f"Picard and corrector inputs, the initial state, operators) ({card})")
    if launches != want:
        fail(f"K5 launched {launches} times in {Z4_EAGER_STEPS} Z4 main-path steps, expected "
             f"{want}")
    if tuple(u.shape) != plain.state_shape or not torch.isfinite(u).all():
        fail("the Z4 main-path state is not finite or has the wrong shape")
    again = kern.run(u0, Z4_EAGER_STEPS, Z4_DT)
    if not torch.equal(u, again):
        fail("two Z4 runs from the same state differ")
    say("[z4 main] two runs from the same state: bitwise equal")
    del again
    # The plain path over the eager depth; the kernel paths after 1 and
    # after as many steps, within that many f32 bounds.
    d1 = cu.step(u0, Z4_DT)
    k1 = u if Z4_EAGER_STEPS == 1 else kern.step(u0, Z4_DT)  # that eager run
    torch.cuda.reset_peak_memory_stats()
    p1 = plain.step(u0, Z4_DT)
    pn = plain.run(p1, Z4_EAGER_STEPS - 1, Z4_DT)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    dn = cu.run(u0, Z4_EAGER_STEPS, Z4_DT)
    for route, n, a, b in (("CudaADERDG", 1, d1, p1), ("CudaADERDG", Z4_EAGER_STEPS, dn, pn),
                           ("with_cuda_rhs", 1, k1, p1), ("with_cuda_rhs", Z4_EAGER_STEPS, u, pn)):
        err, limit = max_err(torch, a, b), n * f32_bound(torch, b)
        say(f"[z4 main] {route}, {n} step(s), kernel path vs plain path: max_abs_err "
            f"{err:.3e} limit {limit:.3e}")
        if not err <= limit:
            fail(f"the Z4 kernel path ({route}) disagrees with the plain path after {n} step(s)")
    del d1, k1, p1, dn

    # Readings: the error against the exact gauge wave, the ADM constraints
    # (in float64, from a float64 solver's operators).
    t_d, t_e = STEPS * Z4_DT, Z4_EAGER_STEPS * Z4_DT
    for label, t, x in (("initial state", 0.0, u0), ("CudaADERDG path", t_d, u_d),
                        ("with_cuda_rhs path", t_e, u), ("plain path", t_e, pn)):
        diff = x.double() - gauge_wave_state(sol64, t=t, amplitude=Z4_AMPLITUDE)
        H, M = solver_constraints(sol64, x.double())
        say(f"[z4 reading] {label} at t = {t!r}: error against "
            f"the exact gauge wave: L2 (nodal RMS over all DOF) {diff.pow(2).mean().sqrt().item()!r}"
            f", max {diff.abs().max().item()!r}; ADM constraints max|H| "
            f"{H.abs().max().item()!r}, max|M| {M.abs().max().item()!r}")
        del diff, H, M
    del sol64, pn, u, u_d

    # ------------------------------------------- times
    d_win = windows(torch, cu, u0, Z4_DT, steps=10)
    k_win = windows(torch, kern, u0, Z4_DT, steps=1, n_windows=1)  # ~0.5 s an eager step
    p_win = windows(torch, plain, u0, Z4_DT, steps=1, n_windows=1)
    for label, win in (("CudaADERDG path", d_win), ("with_cuda_rhs path", k_win),
                       ("plain path", p_win)):
        ms = [1e3 * w for w in win]
        say(f"[z4 time] {label}: step ms per window {ms!r}; median {statistics.median(ms)!r} "
            f"ms, {dofs / statistics.median(win)!r} DOF-updates/s ({dofs} DOF per step; {card})")
    new, faces, _ = cu.predictor_volume(u0, Z4_DT)
    fhat, fhalf = cu.face_flux(faces)
    pred, flux, update = cu.kernels
    d_times = {  # the plain stages' times: their full-width parity call's
        pred: (event_ms(torch, lambda: cu.predictor_volume(u0, Z4_DT), 20), plain_times[pred]),
        flux: (event_ms(torch, lambda: cu.face_flux(faces), 20), plain_times[flux]),
        update: (event_ms(torch, lambda: cu.surface_update(new, fhat, Z4_DT, fhalf=fhalf), 20),
                 plain_times[update]),
        "face stage": (event_ms(torch, lambda: cu.face_surface(new, faces, Z4_DT), 20),
                       plain_times["face stage"]),
        "step": (event_ms(torch, lambda: cu.step(u0, Z4_DT), 20),
                 1e3 * p_win[0]),  # the plain step's host window above
    }
    for name, (ms, plain_ms) in d_times.items():
        say(f"[z4 time] K1 d {name}: kernel {ms!r} ms, plain {plain_ms!r} ms (CUDA events; "
            f"the plain step's: its host window; {card})")
    q_st = pic[0]
    k5_ms = {
        "Picard": event_ms(torch, lambda: k5(*pic), 20),
        "corrector": event_ms(torch, lambda: k5(*cor), 20),
    }
    k5_plain_ms = {
        "Picard": event_ms(torch, lambda: plain.rhs_all_fn(*pic), 2),
        "corrector": event_ms(torch, lambda: plain.rhs_all_fn(*cor), 2),
    }
    parts = {
        "step": event_ms(torch, lambda: kern.step(u0, Z4_DT), 1),
        "predictor_volume": event_ms(torch, lambda: kern.predictor_volume(u0, Z4_DT), 1),
        "face_surface (6 ncp_fn evaluations, 6 wave speeds)": event_ms(
            torch, lambda: kern.face_surface(new, faces, Z4_DT), 1),
        "source_fn on the space-time array (s̄)": event_ms(
            torch, lambda: kern.source_fn(q_st, pic[2]), 1),
        "one Picard gradient triple (tensordot, /dx, contiguous)": event_ms(
            torch, lambda: kern._grads(q_st, 1), 3),
    }
    k5_in_step = iters * k5_ms["Picard"] + 2 * k5_ms["corrector"]
    say(f"[z4 time] K5 per launch (CUDA events, 20 launches): Picard shape "
        f"{tuple(pic[0].shape)} {k5_ms['Picard']!r} ms, corrector shape {tuple(cor[0].shape)} "
        f"{k5_ms['corrector']!r} ms; plain rhs_all_fn {k5_plain_ms['Picard']!r} / "
        f"{k5_plain_ms['corrector']!r} ms ({card})")
    say(f"[z4 time] with_cuda_rhs per call (CUDA events; the device timeline of eager work, "
        f"gaps included): " + ", ".join(f"{k} {v!r} ms" for k, v in parts.items())
        + f"; K5's {iters + 2} launches {k5_in_step!r} ms of the step, the rest "
        f"{parts['step'] - k5_in_step!r} ms ({card})")
    idle, busy, wall = idle_share(torch, lambda: cu.run(u0, 20, Z4_DT))
    say(f"[z4 idle] CudaADERDG path, 20 steps under torch.profiler: device busy {busy!r} ms of "
        f"wall {wall!r} ms; idle share {idle!r} ({card})")
    say(f"[z4 mem] peak allocated over {STEPS} steps: CudaADERDG path {d_peak * gib:.4f} GiB, "
        f"with_cuda_rhs path {peak * gib:.4f} GiB, plain path {plain_peak * gib:.4f} GiB "
        f"({card})")

    # ------------------------------------------- bounds
    counts = z4_point_ops(torch, plain.rhs_all_fn)
    per_point = sum(counts.values())
    q_slots, grad_slots = z4_slots_read(torch, plain.rhs_all_fn)
    bounds = {}
    for name, (Q, _, va) in (("Picard", pic), ("corrector", cor)):
        points = Q.numel() // Q.shape[va]
        n_bytes = Q.element_size() * points * (q_slots + grad_slots + Q.shape[va])
        bounds[name] = bound(n_bytes, per_point * points)
        say(f"[bound] rhs_all_z4 {name} shape {tuple(Q.shape)} f32: {per_point} operations a "
            f"point ({counts}, counted on the plain algebra), {points} points, "
            f"{n_bytes} B ({q_slots} state slots and {grad_slots} gradient slots read, as "
            f"the plain algebra reads them, {Q.shape[va]} written): bound "
            f"{bounds[name]['bound_ms']!r} ms by {bounds[name]['bound_by']}; kernel "
            f"{k5_ms[name]!r} ms ({card})")
    full = z4_value_ops(torch, plain.rhs_all_fn)
    zero = z4_value_ops(torch, plain.rhs_all_fn, ())
    axes = [z4_value_ops(torch, plain.rhs_all_fn, (k,)) for k in range(3)]
    one_axis = sum(axes) / 3
    say(f"[bound] the algebra's operations at a point with no zero state slot "
        f"(z4_value_ops): every gradient axis {full}, none {zero}, one {axes} (the products "
        f"and sums with a zero gradient row need none; the plain count on flat space with "
        f"zero gradients is {per_point})")
    work = z4_kernel_work(Z4_ORDER, iters, ncell, u0.element_size(), full, zero, one_axis)
    work["face stage"] = tuple(a + b for a, b in zip(work[flux], work[update]))
    lines = []
    for name in (pred, flux, update, "face stage"):
        bnd = kernel_report(None if name == "face stage" else cu, name, torch.float32,
                            f"(vacuum Z4) {Z4_GRID} f32", d_times[name][0], *work[name], card)
        if name == "face stage":
            continue
        lines.append(kernel_line(f"{name} (vacuum Z4, K1 d)", "exahype_tpu/models/aderdg_pallas.py:156",
                                 d_launches[name], k1d_errs[name], *d_times[name], bnd,
                                 "exahype_tpu_torch/csrc/aderdg_z4.cuh"))
    del kern, plain, cu, u0, pic, cor, q_st, new, faces, fhat, fhalf
    torch.cuda.empty_cache()
    return lines + [{
        "name": "rhs_all_z4",
        "route": "cuda",
        "source": "exahype_tpu_torch/csrc/rhs.cu",
        "replaces": "exahype_tpu/models/rhs_pallas.py:104",
        "launches": launches,
        "max_abs_err": k5_err,
        "ms": k5_ms["Picard"],
        "plain_ms": k5_plain_ms["Picard"],
        **bounds["Picard"],
        "library_ms": None,  # no single PyTorch call computes it
    }]


def z4_shift_path(torch, dev, card) -> list[dict]:
    """The shifted dynamic-GR path: the 53-variable Gamma-driver step through
    ``CudaADERDG`` (K1 d's shifted instance, ``csrc/aderdg_z4_shift.cu``),
    and the ``with_cuda_rhs`` route (K5 c, ``rhs_all_z4_shift``); returns
    their lines of the kernel JSON."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import (
        make_z4_shift_solver,
        moving_gauge_wave_state,
        solver_constraints,
    )

    def make(grid, dtype, **params):
        plain = make_z4_shift_solver(3, Z4_ORDER, grid, dx=Z4_DX, fused_rhs="soa", device=dev,
                                     dtype=dtype, **params)
        return plain, with_cuda_rhs(plain)

    def noisy(sol, seed=5):
        u = moving_gauge_wave_state(sol, v=Z4S_V, amplitude=Z4_AMPLITUDE)
        noise = torch.from_numpy(np.random.default_rng(seed).standard_normal(u.shape))
        return (u + Z4S_NOISE * noise.to(u)).contiguous()

    t0 = time.perf_counter()

    def phase(what):
        say(f"[z4s] {what}: {time.perf_counter() - t0:.1f} s into the path (host clock)")

    # ------------------------------------------- kernels vs plain, float64, cut grid
    for params in Z4S_FAMILIES:
        plain64, kern64 = make(Z4_CUT, torch.float64, **params)
        k5_64 = kern64.rhs_all_fn
        which = f"{k5_64.inner.physics.params}"
        u = noisy(plain64)
        for i, (Q, grads, va) in enumerate(z4_rhs_calls(plain64, u, Z4_DT)):
            got, again = k5_64(Q, grads, va), k5_64(Q, grads, va)
            ref = plain64.rhs_all_fn(Q, grads, va)
            torch.cuda.synchronize()
            err = max_err(torch, got, ref)
            limit = Z4_F64_RTOL * max(1.0, ref.abs().max().item())
            ok = err <= limit and torch.equal(got, again)
            name = z4_call_name(i, plain64.picard_iters)
            say(f"[z4s parity] rhs_all_z4_shift float64 {Z4_CUT} noisy moving wave (slicing, f, "
                f"m, κ₁, κ₂, shift, f_b, η) = {which} {name} "
                f"{tuple(Q.shape)}: max_abs_err {err:.3e} limit {limit:.3e} ({Z4_F64_RTOL:.0e} x "
                f"max(1, max|plain| = {ref.abs().max().item():.4g})); repeat bitwise "
                f"{torch.equal(got, again)} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K5 c (float64, {which}, {name}) disagrees with its plain version")
        step_k, step_p = kern64.step(u, Z4_DT), plain64.step(u, Z4_DT)
        err = max_err(torch, step_k, step_p)
        limit = Z4_F64_RTOL * max(1.0, step_p.abs().max().item())
        say(f"[z4s parity] one float64 step {Z4_CUT} {which} through with_cuda_rhs vs the plain "
            f"step: max_abs_err {err:.3e} limit {limit:.3e}; K5 c launches {k5_64.launches}")
        if not err <= limit:
            fail(f"the float64 shifted Z4 step through K5 c disagrees with the plain step "
                 f"({which})")
        z4_kernel_parity(torch, plain64, CudaADERDG(plain64), u, Z4_DT, f"K1 d shifted {which}",
                         tag="z4s")
        del plain64, kern64, k5_64, u, got, again, ref, step_k, step_p

    phase("the float64 parity of three families")

    # ------------------------------------------- kernels vs plain, float32, full width
    plain, kern = make(Z4_GRID, torch.float32, **Z4S_PARAMS)
    sol64, _ = make(Z4_GRID, torch.float64, **Z4S_PARAMS)
    cu = CudaADERDG(plain)
    k5 = kern.rhs_all_fn
    iters = plain.picard_iters
    u0 = moving_gauge_wave_state(plain, v=Z4S_V, amplitude=Z4_AMPLITUDE)
    un = noisy(plain)
    ncell = math.prod(Z4_GRID)
    dofs = plain.dofs()
    cfl = float(plain.cfl_dt(u0))
    say(f"[z4s] {Z4_GRID} cells, order {Z4_ORDER}, 53 vars, {Z4S_PARAMS}, moving gauge wave v = "
        f"{Z4S_V} amplitude {Z4_AMPLITUDE}: {dofs} DOF, state {u0.nbytes} B f32; dt = {Z4_DT!r} "
        f"(scripts/z4_probe.py:56); cfl_dt(initial state) = {cfl!r} (dt / cfl_dt = "
        f"{Z4_DT / cfl!r}); picard_iters {iters}")
    if Z4_DT > cfl:
        fail(f"dt = {Z4_DT} is over the shifted state's CFL limit {cfl}")
    calls = z4_rhs_calls(plain, un, Z4_DT)
    k5_err = 0.0
    for i in (0, iters):  # the Picard shape, the corrector's
        Q, grads, va = calls[i]
        got = k5(Q, grads, va)
        ref = plain.rhs_all_fn(Q, grads, va)
        ref64 = plain.rhs_all_fn(Q.double(), tuple(g.double() for g in grads), va)
        torch.cuda.synchronize()
        err, limit = max_err(torch, got, ref), f32_bound(torch, ref)
        to64_k, to64_p = max_err(torch, got, ref64), max_err(torch, ref, ref64)
        ok = err <= limit
        say(f"[z4s parity] rhs_all_z4_shift float32 {Z4_GRID} noisy moving wave "
            f"{z4_call_name(i, iters)} {tuple(Q.shape)}: max_abs_err {err:.3e} limit "
            f"{limit:.3e} ({F32_ULPS} f32 spacings of max|plain| = {ref.abs().max().item():.4g}) "
            f"{'ok' if ok else 'FAIL'}; against the float64 plain result: kernel {to64_k:.3e}, "
            f"plain float32 {to64_p:.3e}")
        if not ok:
            fail(f"K5 c (float32, {z4_call_name(i, iters)}) disagrees with its plain version")
        k5_err = max(k5_err, err)
        del got, ref, ref64
    pic, cor = calls[0], calls[iters]
    del calls
    plain_times = {}  # the plain stages' times, as the parity call runs them
    k1d_errs = z4_kernel_parity(torch, plain, cu, un, Z4_DT, "K1 d shifted, the path's own",
                                sol64, tag="z4s", plain_ms=plain_times)
    del un
    torch.cuda.empty_cache()
    phase("the float32 parity at full width")

    # ------------------------------------------- the main path: CudaADERDG
    gib = 2.0**-30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cu.reset_launches()
    u_d = cu.run(u0, STEPS, Z4_DT)
    torch.cuda.synchronize()
    d_launches = dict(cu.launches)
    d_peak = torch.cuda.max_memory_allocated()
    say(f"[z4s main] {STEPS} steps of {Z4_GRID} f32 through CudaADERDG(make_z4_shift_solver(..., "
        f"fused_rhs='soa')): launches {d_launches} (expected {STEPS} of each: 3 a step); peak "
        f"{d_peak * gib:.4f} GiB allocated ({held * gib:.4f} GiB held before) ({card})")
    if d_launches != {name: STEPS for name in cu.kernels}:
        fail(f"the shifted Z4 step through CudaADERDG launched {d_launches} in {STEPS} steps, "
             "expected 3 a step")
    if tuple(u_d.shape) != plain.state_shape or not torch.isfinite(u_d).all():
        fail("the shifted Z4 state through CudaADERDG is not finite or has the wrong shape")
    if not torch.equal(u_d, cu.run(u0, STEPS, Z4_DT)):
        fail("two shifted Z4 runs through CudaADERDG from the same state differ")
    say("[z4s main] CudaADERDG: two runs from the same state: bitwise equal")

    # ------------------------------------------- the with_cuda_rhs route (K5 c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5.reset_launches()
    u_k = kern.run(u0, Z4_EAGER_STEPS, Z4_DT)
    torch.cuda.synchronize()
    launches = k5.launches
    peak = torch.cuda.max_memory_allocated()
    want = (iters + 2) * Z4_EAGER_STEPS
    say(f"[z4s main] {Z4_EAGER_STEPS} steps of {Z4_GRID} f32 through make_z4_shift_solver + "
        f"with_cuda_rhs: K5 c launches {launches} (expected (picard_iters + 2) x steps = "
        f"{want}); peak {peak * gib:.4f} GiB allocated ({card})")
    if launches != want:
        fail(f"K5 c launched {launches} times in {Z4_EAGER_STEPS} shifted Z4 steps, expected "
             f"{want}")
    if tuple(u_k.shape) != plain.state_shape or not torch.isfinite(u_k).all():
        fail("the shifted Z4 state through with_cuda_rhs is not finite or has the wrong shape")
    d1 = cu.step(u0, Z4_DT)
    k1 = u_k if Z4_EAGER_STEPS == 1 else kern.step(u0, Z4_DT)  # that eager run
    torch.cuda.reset_peak_memory_stats()
    p1 = plain.step(u0, Z4_DT)
    pn = plain.run(p1, Z4_EAGER_STEPS - 1, Z4_DT)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    dn = cu.run(u0, Z4_EAGER_STEPS, Z4_DT)
    for route, n, a, b in (("CudaADERDG", 1, d1, p1), ("CudaADERDG", Z4_EAGER_STEPS, dn, pn),
                           ("with_cuda_rhs", 1, k1, p1),
                           ("with_cuda_rhs", Z4_EAGER_STEPS, u_k, pn)):
        err, limit = max_err(torch, a, b), n * f32_bound(torch, b)
        say(f"[z4s main] {route}, {n} step(s), kernel path vs plain path: max_abs_err "
            f"{err:.3e} limit {limit:.3e}")
        if not err <= limit:
            fail(f"the shifted Z4 kernel path ({route}) disagrees with the plain path after "
                 f"{n} step(s)")
    del d1, k1, p1, dn

    phase("the main runs and the plain path")

    # Readings: the error against the exact moving gauge wave (every slot,
    # and slots 0-37: the Gamma-driver's b follows ∂_t Γ, which the wave in
    # moving coordinates does not hold at 0), the ADM constraints (float64,
    # from a float64 solver's operators), and how far the Gamma-driver moved β, b.
    t_d, t_e = STEPS * Z4_DT, Z4_EAGER_STEPS * Z4_DT
    va = plain.var_axis
    for label, t, x in (("initial state", 0.0, u0), ("CudaADERDG path", t_d, u_d),
                        ("with_cuda_rhs path", t_e, u_k), ("plain path", t_e, pn)):
        diff = x.double() - moving_gauge_wave_state(sol64, t=t, v=Z4S_V, amplitude=Z4_AMPLITUDE)
        core = diff.narrow(va, 0, 38)
        H, M = solver_constraints(sol64, x.double())
        beta = x.narrow(va, 38, 1).double()
        b = x.narrow(va, 41, 3).double()
        say(f"[z4s reading] {label} at t = {t!r}: error against the "
            f"exact moving gauge wave: L2 (nodal RMS over all DOF) "
            f"{diff.pow(2).mean().sqrt().item()!r}, max {diff.abs().max().item()!r}; over slots "
            f"0-37 L2 {core.pow(2).mean().sqrt().item()!r}, max {core.abs().max().item()!r}; ADM "
            f"constraints max|H| {H.abs().max().item()!r}, max|M| {M.abs().max().item()!r}; "
            f"max|β^x − v| {(beta - Z4S_V).abs().max().item()!r}, max|b| "
            f"{b.abs().max().item()!r}")
        if x is not u0 and not (b.abs().max().item() > 0 and (beta - Z4S_V).abs().max() > 0):
            fail(f"the Gamma-driver did not move β and b ({label})")
        del diff, core, H, M, beta, b
    del sol64, pn, u_k, u_d
    phase("the readings")

    # ------------------------------------------- times
    d_win = windows(torch, cu, u0, Z4_DT, steps=10)
    k_win = windows(torch, kern, u0, Z4_DT, steps=1, n_windows=1)
    p_win = windows(torch, plain, u0, Z4_DT, steps=1, n_windows=1)
    for label, win in (("CudaADERDG path", d_win), ("with_cuda_rhs path", k_win),
                       ("plain path", p_win)):
        ms = [1e3 * w for w in win]
        say(f"[z4s time] {label}: step ms per window {ms!r}; median {statistics.median(ms)!r} "
            f"ms, {dofs / statistics.median(win)!r} DOF-updates/s ({dofs} DOF per step; {card})")
    new, faces, _ = cu.predictor_volume(u0, Z4_DT)
    fhat, fhalf = cu.face_flux(faces)
    pred, flux, update = cu.kernels
    d_times = {  # the plain stages' times: their full-width parity call's
        pred: (event_ms(torch, lambda: cu.predictor_volume(u0, Z4_DT), 20), plain_times[pred]),
        flux: (event_ms(torch, lambda: cu.face_flux(faces), 20), plain_times[flux]),
        update: (event_ms(torch, lambda: cu.surface_update(new, fhat, Z4_DT, fhalf=fhalf), 20),
                 plain_times[update]),
        "face stage": (event_ms(torch, lambda: cu.face_surface(new, faces, Z4_DT), 20),
                       plain_times["face stage"]),
        "step": (event_ms(torch, lambda: cu.step(u0, Z4_DT), 20),
                 1e3 * p_win[0]),  # the plain step's host window above
    }
    u1 = cu.step(u0, Z4_DT)
    stepped = event_ms(torch, lambda: cu.predictor_volume(u1, Z4_DT), 20)
    for name, (ms, plain_ms) in d_times.items():
        say(f"[z4s time] K1 d shifted {name}: kernel {ms!r} ms, plain {plain_ms!r} ms (CUDA "
            f"events; the plain step's: its host window; {card})")
    say(f"[z4s time] K1 d shifted {pred} on the state after one step: {stepped!r} ms ({card})")
    k5_ms = {
        "Picard": event_ms(torch, lambda: k5(*pic), 20),
        "corrector": event_ms(torch, lambda: k5(*cor), 20),
    }
    k5_plain_ms = {
        "Picard": event_ms(torch, lambda: plain.rhs_all_fn(*pic), 2),
        "corrector": event_ms(torch, lambda: plain.rhs_all_fn(*cor), 2),
    }
    say(f"[z4s time] K5 c per launch (CUDA events, 20 launches): Picard shape "
        f"{tuple(pic[0].shape)} {k5_ms['Picard']!r} ms, corrector shape {tuple(cor[0].shape)} "
        f"{k5_ms['corrector']!r} ms; plain rhs_all_fn {k5_plain_ms['Picard']!r} / "
        f"{k5_plain_ms['corrector']!r} ms ({card})")
    phase("the times before the idle shares")
    idle, busy, wall = idle_share(torch, lambda: cu.run(u0, 20, Z4_DT))
    say(f"[z4s idle] CudaADERDG path, 20 steps under torch.profiler: device busy {busy!r} ms of "
        f"wall {wall!r} ms; idle share {idle!r} ({card})")
    say(f"[z4s mem] peak allocated over {STEPS} steps: CudaADERDG path {d_peak * gib:.4f} GiB, "
        f"with_cuda_rhs path {peak * gib:.4f} GiB, plain path {plain_peak * gib:.4f} GiB "
        f"({card})")

    phase("the times")

    # ------------------------------------------- bounds
    counts = z4_point_ops(torch, plain.rhs_all_fn)
    per_point = sum(counts.values())
    q_slots, grad_slots = z4_slots_read(torch, plain.rhs_all_fn)
    bounds = {}
    for name, (Q, _, va_) in (("Picard", pic), ("corrector", cor)):
        points = Q.numel() // Q.shape[va_]
        n_bytes = Q.element_size() * points * (q_slots + grad_slots + Q.shape[va_])
        bounds[name] = bound(n_bytes, per_point * points)
        say(f"[bound] rhs_all_z4_shift {name} shape {tuple(Q.shape)} f32: {per_point} operations "
            f"a point ({counts}, counted on the plain algebra), {points} points, {n_bytes} B "
            f"({q_slots} state slots and {grad_slots} gradient slots read, as the plain "
            f"algebra reads them, {Q.shape[va_]} written): bound "
            f"{bounds[name]['bound_ms']!r} ms by {bounds[name]['bound_by']}; kernel "
            f"{k5_ms[name]!r} ms ({card})")
    full = z4_value_ops(torch, plain.rhs_all_fn)
    zero = z4_value_ops(torch, plain.rhs_all_fn, ())
    axes = [z4_value_ops(torch, plain.rhs_all_fn, (k,)) for k in range(3)]
    say(f"[bound] the shifted algebra's operations at a point with no zero state slot "
        f"(z4_value_ops): every gradient axis {full}, none {zero}, one {axes}; gradient slots "
        f"read {grad_slots // 3} an axis (the plain count on flat space with zero gradients "
        f"is {per_point})")
    work = z4_kernel_work(Z4_ORDER, iters, ncell, u0.element_size(), full, zero,
                          sum(axes) / 3, v=plain.n_vars, gs=grad_slots // 3, eig_ops=25,
                          suffix="z4_shift")
    work["face stage"] = tuple(a + b for a, b in zip(work[flux], work[update]))
    lines = []
    for name in (pred, flux, update, "face stage"):
        bnd = kernel_report(None if name == "face stage" else cu, name, torch.float32,
                            f"(shifted Z4) {Z4_GRID} f32", d_times[name][0], *work[name], card)
        if name == "face stage":
            continue
        lines.append(kernel_line(f"{name} (shifted Z4, K1 d)",
                                 "exahype_tpu/models/aderdg_pallas.py:156", d_launches[name],
                                 k1d_errs[name], *d_times[name], bnd,
                                 "exahype_tpu_torch/csrc/aderdg_z4.cuh"))
    del kern, plain, cu, u0, u1, pic, cor, new, faces, fhat, fhalf
    torch.cuda.empty_cache()
    return lines + [{
        "name": "rhs_all_z4_shift",
        "route": "cuda",
        "source": "exahype_tpu_torch/csrc/rhs.cu",
        "replaces": "exahype_tpu/models/rhs_pallas.py:104",
        "launches": launches,
        "max_abs_err": k5_err,
        "ms": k5_ms["Picard"],
        "plain_ms": k5_plain_ms["Picard"],
        **bounds["Picard"],
        "library_ms": None,  # no single PyTorch call computes it
    }]


def node_weights(torch, sol, u):
    """The Gauss weights of a cell's nodes, the product over ``sol``'s axes
    (float64, on ``u``'s device), shaped to broadcast over ``u``."""
    w = sol.weights.to(device=u.device, dtype=torch.float64)
    if sol.dim == 3:
        wn = w[:, None, None] * w[None, :, None] * w[None, None, :]
    else:
        wn = w[:, None] * w[None, :]
    return wn.reshape((sol.n_nodes,) * sol.dim + (1,) * (u.dim() - sol.dim))


def z4m_integral(torch, sol, u, slot: int) -> float:
    """∫ Q_slot dV over the grid: the nodal values times the Gauss weights
    of each cell's nodes and the cell volume, summed in float64."""
    q = u.narrow(sol.var_axis, slot, 1).double()
    return float((q * node_weights(torch, sol, u)).sum()) * math.prod(sol._dxs)


def z4m_flrw(torch, sol, rho0=Z4M_RHO0, eps0=Z4M_EPS0, perturb=True):
    """``examples/flrw_cosmology.py``'s FLRW slice at a = 1 on ``sol`` (its
    dtype and device), with ``scripts/z4_probe.py --matter``'s perturbation
    of D̃ and τ̃ along the last grid axis (axis 2 in 3-D) where
    ``perturb``; and ȧ."""
    from exahype_tpu_torch.models.z4_matter import flrw_state

    adot = math.sqrt(8.0 * math.pi * rho0 * (1.0 + eps0) / 3.0)
    u = flrw_state(sol, 1.0, adot, rho0=rho0, eps0=eps0)
    if perturb:
        g2 = sol.grid_shape[-1]
        pert = 1.0 + Z4M_PERT * torch.sin(
            2.0 * math.pi * torch.arange(g2, dtype=torch.float64) / g2)
        for slot in (38, 42):
            u.narrow(sol.var_axis, slot, 1).mul_(pert.to(u))
    return u.contiguous(), adot


def z4m_noisy(torch, sol, seed=5):
    """A parity state (``Z4M_NOISE``): ``pack_matter`` of the FLRW metric
    (γ ≈ δ, K ≈ −ȧ δ) with seeded noise on every Z4 slot, and a fluid with
    ρ ≈ 0.02, p ≈ 0.008 and a seeded velocity field."""
    import numpy as np

    from exahype_tpu_torch.models.z4_matter import pack_matter

    va = sol.var_axis
    shape = sol.state_shape[:va] + sol.state_shape[va + 1:]
    rng = np.random.default_rng(seed)
    z4 = Z4M_NOISE * rng.standard_normal(shape + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    z4[..., [7, 10, 12]] -= math.sqrt(8.0 * math.pi * Z4M_RHO0 * (1.0 + Z4M_EPS0) / 3.0)
    rho = Z4M_RHO0 * (1.0 + 0.1 * rng.random(shape))
    p = (5.0 / 3.0 - 1.0) * Z4M_RHO0 * Z4M_EPS0 * (1.0 + 0.1 * rng.random(shape))
    v = 0.3 * (rng.random(shape + (3,)) - 0.5)
    q = pack_matter(*(torch.from_numpy(x) for x in (z4, rho, v, p)))
    return q.movedim(-1, va).to(device=sol.weights.device, dtype=sol.weights.dtype).contiguous()


def z4_matter_path(torch, dev, card) -> list[dict]:
    """The Z4+GRHD path: the 43-variable coupled step through ``CudaADERDG``
    (K1 d's conservative-flux variant, ``csrc/aderdg_z4_matter.cu``) and the
    ``with_cuda_rhs`` route (K5 d, ``rhs_all_z4_matter``); returns their
    lines of the kernel JSON."""
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4_matter import (
        flrw_reference,
        make_z4_matter_solver,
        z4_matter_admissible,
    )

    def make(grid, dtype, **params):
        plain = make_z4_matter_solver(3, Z4_ORDER, grid, dx=Z4_DX, fused_rhs="soa", device=dev,
                                      dtype=dtype, **params)
        return plain, with_cuda_rhs(plain)

    admissible = z4_matter_admissible()
    t0 = time.perf_counter()

    def phase(what):
        say(f"[z4m] {what}: {time.perf_counter() - t0:.1f} s into the path (host clock)")

    # ------------------------------------------- kernels vs plain, float64, cut grid
    for params in Z4M_FAMILIES:
        plain64, kern64 = make(Z4_CUT, torch.float64, **params)
        k5_64 = kern64.rhs_all_fn
        which = f"{k5_64.inner.physics.params}"
        u = z4m_noisy(torch, plain64)
        if not bool(admissible(u, plain64.var_axis).all()):
            fail(f"the Z4+GRHD parity state is not admissible ({which})")
        for i, (Q, grads, va) in enumerate(z4_rhs_calls(plain64, u, Z4_DT)):
            got, again = k5_64(Q, grads, va), k5_64(Q, grads, va)
            ref = plain64.rhs_all_fn(Q, grads, va)
            torch.cuda.synchronize()
            err = max_err(torch, got, ref)
            limit = Z4_F64_RTOL * max(1.0, ref.abs().max().item())
            ok = err <= limit and torch.equal(got, again)
            name = z4_call_name(i, plain64.picard_iters)
            say(f"[z4m parity] rhs_all_z4_matter float64 {Z4_CUT} moving fluid, noisy Z4 slots "
                f"(slicing, f, m, κ₁, κ₂, Γ, iters) = {which} {name} {tuple(Q.shape)}: "
                f"max_abs_err {err:.3e} limit {limit:.3e} ({Z4_F64_RTOL:.0e} x max(1, "
                f"max|plain| = {ref.abs().max().item():.4g})); repeat bitwise "
                f"{torch.equal(got, again)} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K5 d (float64, {which}, {name}) disagrees with its plain version")
        step_k, step_p = kern64.step(u, Z4_DT), plain64.step(u, Z4_DT)
        err = max_err(torch, step_k, step_p)
        limit = Z4_F64_RTOL * max(1.0, step_p.abs().max().item())
        say(f"[z4m parity] one float64 step {Z4_CUT} {which} through with_cuda_rhs vs the plain "
            f"step: max_abs_err {err:.3e} limit {limit:.3e}; K5 d launches {k5_64.launches}")
        if not err <= limit:
            fail(f"the float64 Z4+GRHD step through K5 d disagrees with the plain step ({which})")
        z4_kernel_parity(torch, plain64, CudaADERDG(plain64), u, Z4_DT, f"K1 d matter {which}",
                         tag="z4m")
        del plain64, kern64, k5_64, u, got, again, ref, step_k, step_p

    phase("the float64 parity of two families")

    # ------------------------------------------- kernels vs plain, float32, full width
    plain, kern = make(Z4_GRID, torch.float32, **Z4M_PARAMS)
    sol64, _ = make(Z4_GRID, torch.float64, **Z4M_PARAMS)
    cu = CudaADERDG(plain)
    k5 = kern.rhs_all_fn
    iters = plain.picard_iters
    va = plain.var_axis
    u0, adot0 = z4m_flrw(torch, plain)
    un = z4m_noisy(torch, plain)
    ncell = math.prod(Z4_GRID)
    dofs = plain.dofs()
    cfl = float(plain.cfl_dt(u0))
    say(f"[z4m] {Z4_GRID} cells, order {Z4_ORDER}, 43 vars, {Z4M_PARAMS}, Γ = 5/3, 10 Newton "
        f"trips; FLRW slice ρ₀ = {Z4M_RHO0}, ε₀ = {Z4M_EPS0}, ȧ = {adot0!r}, D̃ and τ̃ times 1 + "
        f"{Z4M_PERT} sin along axis 2: {dofs} DOF, state {u0.nbytes} B f32; dt = {Z4_DT!r}; "
        f"cfl_dt(initial state) = {cfl!r} (dt / cfl_dt = {Z4_DT / cfl!r}); picard_iters {iters}")
    if Z4_DT > cfl:
        fail(f"dt = {Z4_DT} is over the Z4+GRHD state's CFL limit {cfl}")
    if not bool(admissible(u0, va).all()):
        fail("the perturbed FLRW state is not admissible")
    calls = z4_rhs_calls(plain, un, Z4_DT)
    k5_err = 0.0
    for i in (0, iters):  # the Picard shape, the corrector's
        Q, grads, va_ = calls[i]
        got = k5(Q, grads, va_)
        ref = plain.rhs_all_fn(Q, grads, va_)
        ref64 = plain.rhs_all_fn(Q.double(), tuple(g.double() for g in grads), va_)
        torch.cuda.synchronize()
        err, limit = max_err(torch, got, ref), f32_bound(torch, ref)
        to64_k, to64_p = max_err(torch, got, ref64), max_err(torch, ref, ref64)
        ok = err <= limit
        say(f"[z4m parity] rhs_all_z4_matter float32 {Z4_GRID} moving fluid, noisy Z4 slots "
            f"{z4_call_name(i, iters)} {tuple(Q.shape)}: max_abs_err {err:.3e} limit "
            f"{limit:.3e} ({F32_ULPS} f32 spacings of max|plain| = {ref.abs().max().item():.4g}) "
            f"{'ok' if ok else 'FAIL'}; against the float64 plain result: kernel {to64_k:.3e}, "
            f"plain float32 {to64_p:.3e}")
        if not ok:
            fail(f"K5 d (float32, {z4_call_name(i, iters)}) disagrees with its plain version")
        k5_err = max(k5_err, err)
        del got, ref, ref64
    del calls
    plain_times = {}  # the plain stages' times, as the parity call runs them
    k1d_errs = z4_kernel_parity(torch, plain, cu, un, Z4_DT, "K1 d matter, the path's own",
                                sol64, tag="z4m", plain_ms=plain_times)
    del un
    torch.cuda.empty_cache()
    phase("the float32 parity at full width")

    # ------------------------------------------- the main path: CudaADERDG
    gib = 2.0**-30
    uw = cu.run(u0, Z4M_WARMUP, Z4_DT)
    mass0 = z4m_integral(torch, plain, uw, 38)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cu.reset_launches()
    u_d = cu.run(uw, STEPS, Z4_DT)
    torch.cuda.synchronize()
    d_launches = dict(cu.launches)
    d_peak = torch.cuda.max_memory_allocated()
    say(f"[z4m main] {Z4M_WARMUP} warm-up steps, then {STEPS} steps of {Z4_GRID} f32 through "
        f"CudaADERDG(make_z4_matter_solver(..., fused_rhs='soa')): launches {d_launches} "
        f"(expected {STEPS} of each: 3 a step); peak {d_peak * gib:.4f} GiB allocated "
        f"({held * gib:.4f} GiB held before) ({card})")
    if d_launches != {name: STEPS for name in cu.kernels}:
        fail(f"the Z4+GRHD step through CudaADERDG launched {d_launches} in {STEPS} steps, "
             "expected 3 a step")
    if tuple(u_d.shape) != plain.state_shape or not torch.isfinite(u_d).all():
        fail("the Z4+GRHD state through CudaADERDG is not finite or has the wrong shape")
    if not bool(admissible(u_d, va).all()):
        fail("the Z4+GRHD state through CudaADERDG is not admissible")
    drift = abs(z4m_integral(torch, plain, u_d, 38) - mass0) / abs(mass0)
    say(f"[z4m main] CudaADERDG: ∫D̃ dV drift over {STEPS} steps {drift!r} (gate {Z4M_DRIFT}); "
        "admissible (z4_matter_admissible) at every node")
    if not drift <= Z4M_DRIFT:
        fail(f"∫D̃ dV drifted by {drift} over {STEPS} Z4+GRHD steps through CudaADERDG")
    if not torch.equal(u_d, cu.run(uw, STEPS, Z4_DT)):
        fail("two Z4+GRHD runs through CudaADERDG from the same state differ")
    say("[z4m main] CudaADERDG: two runs from the same state: bitwise equal")

    # ------------------------------------------- the with_cuda_rhs route (K5 d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5.reset_launches()
    u_k = kern.run(uw, Z4_EAGER_STEPS, Z4_DT)
    torch.cuda.synchronize()
    launches = k5.launches
    peak = torch.cuda.max_memory_allocated()
    want = (iters + 2) * Z4_EAGER_STEPS
    say(f"[z4m main] {Z4_EAGER_STEPS} steps of {Z4_GRID} f32 through make_z4_matter_solver + "
        f"with_cuda_rhs: K5 d launches {launches} (expected (picard_iters + 2) x steps = "
        f"{want}); peak {peak * gib:.4f} GiB allocated ({card})")
    if launches != want:
        fail(f"K5 d launched {launches} times in {Z4_EAGER_STEPS} Z4+GRHD steps, expected "
             f"{want}")
    if tuple(u_k.shape) != plain.state_shape or not torch.isfinite(u_k).all():
        fail("the Z4+GRHD state through with_cuda_rhs is not finite or has the wrong shape")
    if not bool(admissible(u_k, va).all()):
        fail("the Z4+GRHD state through with_cuda_rhs is not admissible")
    d1 = cu.step(uw, Z4_DT)
    k1 = u_k if Z4_EAGER_STEPS == 1 else kern.step(uw, Z4_DT)  # that eager run
    torch.cuda.reset_peak_memory_stats()
    p1 = plain.step(uw, Z4_DT)
    pn = plain.run(p1, Z4_EAGER_STEPS - 1, Z4_DT)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    dn = cu.run(uw, Z4_EAGER_STEPS, Z4_DT)
    for route, n, a, b in (("CudaADERDG", 1, d1, p1), ("CudaADERDG", Z4_EAGER_STEPS, dn, pn),
                           ("with_cuda_rhs", 1, k1, p1),
                           ("with_cuda_rhs", Z4_EAGER_STEPS, u_k, pn)):
        err, limit = max_err(torch, a, b), n * f32_bound(torch, b)
        say(f"[z4m main] {route}, {n} step(s), kernel path vs plain path: max_abs_err "
            f"{err:.3e} limit {limit:.3e}")
        if not err <= limit:
            fail(f"the Z4+GRHD kernel path ({route}) disagrees with the plain path after "
                 f"{n} step(s)")
    del d1, k1, p1, dn
    phase("the main runs and the plain path")

    # Readings of the perturbed run: the constraint sector (Θ, Z), how far
    # the fluid moved, and the drift of ∫τ̃ dV (not conserved: the
    # expansion's work).
    t_d, t_e = (Z4M_WARMUP + STEPS) * Z4_DT, (Z4M_WARMUP + Z4_EAGER_STEPS) * Z4_DT
    for label, t, x in (("CudaADERDG path", t_d, u_d), ("with_cuda_rhs path", t_e, u_k),
                        ("plain path", t_e, pn)):
        th = x.narrow(va, 13, 1).double().abs().max().item()
        zz = x.narrow(va, 14, 3).double().abs().max().item()
        st = x.narrow(va, 39, 3).double().abs().max().item()
        say(f"[z4m reading] {label} at t = {t!r} from the perturbed "
            f"FLRW slice: max|Θ| {th!r}, max|Z_i| {zz!r}, max|S̃_i| {st!r}, ∫D̃ dV "
            f"{z4m_integral(torch, plain, x, 38)!r} (after the warm-up {mass0!r}), ∫τ̃ dV "
            f"{z4m_integral(torch, plain, x, 42)!r}")
    del pn, u_k, u_d

    # The exact homogeneous FLRW universe: 10 steps to t = 1e-3 through
    # CudaADERDG in float32 against the Friedmann reference (RK4), and in
    # float64 on a cut grid (every cell alike) beside it.
    t_end = STEPS * Z4_DT
    a_ref, adot_ref = (float(x) for x in flrw_reference(t_end, rho0=Z4M_RHO0, eps0=Z4M_EPS0))
    uh, _ = z4m_flrw(torch, plain, perturb=False)
    flat64, _ = make((2, 2, 2), torch.float64, **Z4M_PARAMS)
    uh64, _ = z4m_flrw(torch, flat64, perturb=False)
    for label, sol, x in (("CudaADERDG f32 " + str(Z4_GRID), cu, uh),
                          ("CudaADERDG f64 (2, 2, 2)", CudaADERDG(flat64), uh64)):
        y = sol.run(x, STEPS, Z4_DT)
        a2 = y.narrow(va, 1, 1).double()
        a2_err = (a2 - a_ref**2).abs().max().item() / a_ref**2
        kxx_err = (y.narrow(va, 7, 1).double() + a_ref * adot_ref).abs().max().item() / abs(
            a_ref * adot_ref)
        d_drift = (y.narrow(va, 38, 1).double() - Z4M_RHO0).abs().max().item() / Z4M_RHO0
        th = y.narrow(va, 13, 1).double().abs().max().item()
        zz = y.narrow(va, 14, 3).double().abs().max().item()
        say(f"[z4m flrw] {label}, homogeneous FLRW, t = {t_end!r}: a² = γ_xx rel. error "
            f"{a2_err!r} (reference a = {a_ref!r}), K_xx rel. error {kxx_err!r}, D̃ drift "
            f"{d_drift!r}, max|Θ| {th!r}, max|Z_i| {zz!r}")
        if sol is cu and not (a2_err <= Z4M_A2_RTOL and d_drift <= Z4M_DRIFT
                              and th <= Z4M_CONSTRAINT and zz <= Z4M_CONSTRAINT):
            fail(f"the homogeneous FLRW run through CudaADERDG misses the Friedmann reference: "
                 f"a² {a2_err} (gate {Z4M_A2_RTOL}), D̃ {d_drift} (gate {Z4M_DRIFT}), |Θ| {th}, "
                 f"|Z| {zz} (gate {Z4M_CONSTRAINT})")
    del uh, uh64, flat64, sol64, y
    phase("the readings and the FLRW anchor")

    # ------------------------------------------- times
    d_win = windows(torch, cu, u0, Z4_DT, steps=10)
    k_win = windows(torch, kern, u0, Z4_DT, steps=1, n_windows=1)
    p_win = windows(torch, plain, u0, Z4_DT, steps=1, n_windows=1)
    for label, win in (("CudaADERDG path", d_win), ("with_cuda_rhs path", k_win),
                       ("plain path", p_win)):
        ms = [1e3 * w for w in win]
        say(f"[z4m time] {label}: step ms per window {ms!r}; median {statistics.median(ms)!r} "
            f"ms, {dofs / statistics.median(win)!r} DOF-updates/s ({dofs} DOF per step; {card})")
    new, faces, _ = cu.predictor_volume(u0, Z4_DT)
    fhat, fhalf = cu.face_flux(faces)
    pred, flux, update = cu.kernels
    d_times = {  # the plain stages' times: their full-width parity call's
        pred: (event_ms(torch, lambda: cu.predictor_volume(u0, Z4_DT), 20), plain_times[pred]),
        flux: (event_ms(torch, lambda: cu.face_flux(faces), 20), plain_times[flux]),
        update: (event_ms(torch, lambda: cu.surface_update(new, fhat, Z4_DT, fhalf=fhalf), 20),
                 plain_times[update]),
        "face stage": (event_ms(torch, lambda: cu.face_surface(new, faces, Z4_DT), 20),
                       plain_times["face stage"]),
        "step": (event_ms(torch, lambda: cu.step(u0, Z4_DT), 20),
                 1e3 * p_win[0]),  # the plain step's host window above
    }
    for name, (ms, plain_ms) in d_times.items():
        say(f"[z4m time] K1 d matter {name}: kernel {ms!r} ms, plain {plain_ms!r} ms (CUDA "
            f"events; the plain step's: its host window; {card})")
    calls = z4_rhs_calls(plain, u0, Z4_DT)
    pic, cor = calls[0], calls[iters]
    del calls
    k5_ms = {
        "Picard": event_ms(torch, lambda: k5(*pic), 20),
        "corrector": event_ms(torch, lambda: k5(*cor), 20),
    }
    k5_plain_ms = {
        "Picard": event_ms(torch, lambda: plain.rhs_all_fn(*pic), 2),
        "corrector": event_ms(torch, lambda: plain.rhs_all_fn(*cor), 2),
    }
    say(f"[z4m time] K5 d per launch (CUDA events, 20 launches): Picard shape "
        f"{tuple(pic[0].shape)} {k5_ms['Picard']!r} ms, corrector shape {tuple(cor[0].shape)} "
        f"{k5_ms['corrector']!r} ms; plain rhs_all_fn {k5_plain_ms['Picard']!r} / "
        f"{k5_plain_ms['corrector']!r} ms ({card})")
    idle, busy, wall = idle_share(torch, lambda: cu.run(u0, 20, Z4_DT))
    say(f"[z4m idle] CudaADERDG path, 20 steps under torch.profiler: device busy {busy!r} ms of "
        f"wall {wall!r} ms; idle share {idle!r} ({card})")
    say(f"[z4m mem] peak allocated over {STEPS} steps: CudaADERDG path {d_peak * gib:.4f} GiB, "
        f"with_cuda_rhs path {peak * gib:.4f} GiB, plain path {plain_peak * gib:.4f} GiB "
        f"({card})")
    phase("the times")

    # ------------------------------------------- bounds
    counts = z4_point_ops(torch, plain.rhs_all_fn)
    per_point = sum(counts.values())
    q_slots, grad_slots = z4_slots_read(torch, plain.rhs_all_fn)
    bounds = {}
    for name, (Q, _, va_) in (("Picard", pic), ("corrector", cor)):
        points = Q.numel() // Q.shape[va_]
        n_bytes = Q.element_size() * points * (q_slots + grad_slots + Q.shape[va_])
        bounds[name] = bound(n_bytes, per_point * points)
        say(f"[bound] rhs_all_z4_matter {name} shape {tuple(Q.shape)} f32: {per_point} "
            f"operations a point ({counts}, counted on the plain algebra, the recovery's 10 "
            f"Newton trips included), {points} points, {n_bytes} B ({q_slots} state slots and "
            f"{grad_slots} gradient slots read, as the plain algebra reads them, "
            f"{Q.shape[va_]} written): bound {bounds[name]['bound_ms']!r} ms by "
            f"{bounds[name]['bound_by']}; kernel {k5_ms[name]!r} ms ({card})")
    full = z4_value_ops(torch, plain.rhs_all_fn)
    zero = z4_value_ops(torch, plain.rhs_all_fn, ())
    axes = [z4_value_ops(torch, plain.rhs_all_fn, (k,)) for k in range(3)]
    say(f"[bound] the Z4+GRHD algebra's operations at a point with no zero state slot "
        f"(z4_value_ops): every gradient axis {full}, none {zero}, one {axes}; gradient slots "
        f"read {grad_slots // 3} an axis (the plain count on flat space at rest with zero "
        f"gradients is {per_point}); the hydro flux of the three axes {Z4M_FLUX_OPS} beside "
        "the shared recovery")
    work = z4_kernel_work(Z4_ORDER, iters, ncell, u0.element_size(), full, zero,
                          sum(axes) / 3, v=plain.n_vars, gs=grad_slots // 3,
                          suffix="z4_matter", hydro=5, flux_ops=Z4M_FLUX_OPS)
    work["face stage"] = tuple(a + b for a, b in zip(work[flux], work[update]))
    lines = []
    for name in (pred, flux, update, "face stage"):
        bnd = kernel_report(None if name == "face stage" else cu, name, torch.float32,
                            f"(Z4+GRHD) {Z4_GRID} f32", d_times[name][0], *work[name], card)
        if name == "face stage":
            continue
        lines.append(kernel_line(f"{name} (Z4+GRHD, K1 d)",
                                 "exahype_tpu/models/aderdg_pallas.py:156", d_launches[name],
                                 k1d_errs[name], *d_times[name], bnd,
                                 "exahype_tpu_torch/csrc/aderdg_z4.cuh"))
    del kern, plain, cu, u0, uw, pic, cor, new, faces, fhat, fhalf
    torch.cuda.empty_cache()
    return lines + [{
        "name": "rhs_all_z4_matter",
        "route": "cuda",
        "source": "exahype_tpu_torch/csrc/rhs.cu",
        "replaces": "exahype_tpu/models/rhs_pallas.py:104",
        "launches": launches,
        "max_abs_err": k5_err,
        "ms": k5_ms["Picard"],
        "plain_ms": k5_plain_ms["Picard"],
        **bounds["Picard"],
        "library_ms": None,  # no single PyTorch call computes it
    }]


def z4l_clump(torch, sol):
    """The limited Z4+GRHD path's initial state on ``sol``: the FLRW slice
    (``z4m_flrw`` without the sine) with D̃ and τ̃ times 1 +
    ``Z4L_AMP``·exp(−|x − c|²/``Z4L_WIDTH``), c the box centre."""
    import numpy as np

    u, _ = z4m_flrw(torch, sol, perturb=False)
    r2 = sum((x - 0.5 * g * h) ** 2
             for x, g, h in zip(node_coords(sol), sol.grid_shape, sol._dxs))
    bump = torch.from_numpy(np.ascontiguousarray(1.0 + Z4L_AMP * np.exp(-r2 / Z4L_WIDTH)))
    bump = bump.unsqueeze(sol.var_axis).to(u)
    for slot in (38, 42):
        u.narrow(sol.var_axis, slot, 1).mul_(bump)
    return u.contiguous()


def z4l_sweep_ops(torch, rhs_all, n_sub: int = 5, nvar: int = 43) -> tuple[int, dict]:
    """Flops a pencil of the Z4+GRHD sweep (``csrc/subcell_ncp.cuh``) needs,
    and its parts: ``n_sub + 2`` states' recovery, hydro flux along the axis
    and wave speed; ``n_sub + 1`` faces' q̃ and Δq (3 a value), Rusanov flux
    (the 38 fluxless rows 3 a value, the 5 hydro rows 5, the max), and NCP
    half (B_d(q̃)·Δq, :func:`z4_ncp_ops` averaged over the axes, halved: 1 a
    value); ``n_sub`` updates (6 a value) and the two edge fluxes' sums (1 a
    value each).  The recovery's count is the plain ``recover``'s, tallied
    as ``z4_tally`` tallies the algebra.  The kernel reaches the NCP as the
    difference of two whole evaluations of the algebra; the work the
    function needs is the product alone."""
    from exahype_tpu_torch.models.z4_matter import recover

    q = z4_base(torch, nvar, 1)
    rec = sum(z4_tally(torch, lambda q_, g_, va: recover(q_.T)[2], q, ()).values())
    ncp = statistics.mean(z4_ncp_ops(torch, rhs_all, k) for k in range(3))
    parts = {
        "states": (n_sub + 2) * (rec + Z4M_FLUX_OPS // 3 + 23),
        "faces": (n_sub + 1) * (3 * nvar + 3 * 38 + 5 * 5 + 1 + ncp + nvar),
        "updates": n_sub * 6 * nvar,
        "edge sums": 2 * nvar,
    }
    return int(sum(parts.values())), {"recovery": rec, "NCP product (mean of the axes)": ncp,
                                      **parts}


def limited_z4_matter_path(torch, dev, card) -> list[dict]:
    """The limited Z4+GRHD path: ``LimitedADERDG`` over the coupled solver,
    its candidate through ``CudaADERDG`` (K1 d) and its gathered sweeps
    through K3 a's Z4+GRHD instance (``subcell_row_sweep_z4_matter``);
    returns K3 a's line of the kernel JSON."""
    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.limiter import LimitedADERDG
    from exahype_tpu_torch.models.z4_matter import make_z4_matter_solver, z4_matter_admissible

    adm = z4_matter_admissible()
    kernel = "subcell_row_sweep_z4_matter"
    t0 = time.perf_counter()

    def phase(what):
        say(f"[z4l] {what}: {time.perf_counter() - t0:.1f} s into the path (host clock)")

    def make(grid, dtype, capacity=CAPACITY):
        sol = make_z4_matter_solver(3, Z4_ORDER, grid, dx=Z4_DX, fused_rhs="soa", device=dev,
                                    dtype=dtype, **Z4M_PARAMS)
        cu = CudaADERDG(sol)
        opts = dict(troubled_capacity=capacity, troubled_granularity="row", device=dev)
        return (sol, cu, LimitedADERDG(sol, adm, accelerator=cu, subcell_cuda=True, **opts),
                LimitedADERDG(sol, adm, **opts))

    # ------------------------------------------- K3 a vs plain, float64, cut grid
    rows64 = Z4_CUT[0] * Z4_CUT[1]
    sol64, _, lim64, plain64 = make(Z4_CUT, torch.float64, capacity=rows64)
    u = z4m_noisy(torch, sol64)
    every = plain64._gather_tables_row(torch.ones(Z4_CUT, dtype=torch.bool, device=dev))
    for d, s, lo, hi in record_sweeps(plain64, u, Z4_DT, every):
        ref = plain64._row_sweep_math(s, lo, hi, d, Z4_DT)
        for n in (rows64, rows64 // 2 - 1):
            k3_check(torch, subcell_cuda, lim64, d, s, lo, hi, n, ref,
                     f"{tuple(s.shape)} ({Z4_CUT} noisy, every row gathered)", dt=Z4_DT,
                     name=kernel, f64_rtol=Z4_F64_RTOL)
    del sol64, lim64, plain64, u, every, s, lo, hi, ref
    phase("K3 a in float64")

    # ------------------------------------------- the main path
    sol, cu, lim, plain = make(Z4_GRID, torch.float32)
    va = sol.var_axis
    u0 = z4l_clump(torch, sol)
    rows = Z4_GRID[0] * Z4_GRID[1]
    say(f"[z4l] {Z4_GRID} cells, order {Z4_ORDER}, 43 vars, {Z4M_PARAMS}, FLRW slice ρ₀ = "
        f"{Z4M_RHO0}, ε₀ = {Z4M_EPS0}, D̃ and τ̃ times 1 + {Z4L_AMP} exp(−|x − c|²/"
        f"{Z4L_WIDTH!r}); dt = {Z4_DT!r}; cfl_dt(initial state) {float(sol.cfl_dt(u0))!r}; "
        f"capacity {CAPACITY} of {rows} rows of {Z4_GRID[-1]} cells, f32")
    if not bool(adm(u0, va).all()):
        fail("the clumped FLRW state is not admissible")

    # The rows each step demands and gathers: the step's own tables, read
    # after the run (no extra synchronisation inside it).
    demand = []
    real_tables = lim._gather_tables_row

    def logged(troubled):
        demand.append(troubled.reshape(rows, -1).any(dim=-1).sum())
        return real_tables(troubled)

    def rows_line(label):
        counts = [int(x) for x in demand]
        say(f"[z4l main] troubled rows per step ({label}): {counts} against capacity "
            f"{CAPACITY}; overflow (the cell-mean update) engaged on "
            f"{sum(c > CAPACITY for c in counts)} of them")
        demand.clear()
        return counts

    lim._gather_tables_row = logged
    uw = lim.run(u0, Z4M_WARMUP, Z4_DT)
    torch.cuda.synchronize()
    warm_rows = rows_line(f"{Z4M_WARMUP} warm-up steps")
    if not warm_rows[0] > 0:
        fail("the detector did not fire on the clump")
    mass0 = z4m_integral(torch, sol, uw, 38)
    gib = 2.0**-30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cu.reset_launches()
    subcell_cuda.reset_launches()
    u = lim.run(uw, STEPS, Z4_DT)
    torch.cuda.synchronize()
    launches = {**cu.launches, **subcell_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    checked_rows = rows_line(f"{STEPS} checked steps")
    lim._gather_tables_row = real_tables
    overflow = max(checked_rows) > CAPACITY
    say(f"[z4l main] {STEPS} steps of {Z4_GRID} f32 through LimitedADERDG after {Z4M_WARMUP} "
        f"warm-up steps: launches {launches}; peak {peak * gib:.4f} GiB allocated ({card})")
    want = {**{name: 0 for name in subcell_cuda.launches},
            **{name: STEPS for name in cu.kernels}, kernel: 3 * STEPS}
    if launches != want:
        fail(f"the limited Z4+GRHD path launches {launches}, expected {want}")
    finite, admissible = bool(torch.isfinite(u).all()), bool(adm(u, va).all())
    drift = abs(z4m_integral(torch, sol, u, 38) - mass0) / abs(mass0)
    say(f"[z4l main] state finite {finite}, admissible (z4_matter_admissible) {admissible}; "
        f"∫D̃ dV drift over {STEPS} steps {drift!r} (gate {MASS_RTOL} when no overflow "
        "engaged)")
    if tuple(u.shape) != sol.state_shape or not (finite and admissible):
        fail("the limited Z4+GRHD state is not finite and admissible")
    if not overflow and not drift <= MASS_RTOL:
        fail(f"∫D̃ dV drifted by {drift} over {STEPS} limited Z4+GRHD steps")
    if not torch.equal(u, lim.run(uw, STEPS, Z4_DT)):
        fail("two limited Z4+GRHD runs from the same state differ")
    say("[z4l main] two runs from the same state: bitwise equal")

    # One step of the kernel path against the plain limited step.
    mask_k = lim.troubled_mask(u, cu.step(u, Z4_DT))
    mask_p = plain.troubled_mask(u, sol.step(u, Z4_DT))
    step_k = lim.step(u, Z4_DT)
    torch.cuda.reset_peak_memory_stats()
    step_p, plain_step_ms = timed_once(torch, lambda: plain.step(u, Z4_DT))
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    err, limit = max_err(torch, step_k, step_p), f32_bound(torch, step_p)
    say(f"[z4l main] one step, kernel path vs plain path: troubled cells "
        f"{int(mask_k.sum())} (kernel candidate) / {int(mask_p.sum())} (plain), masks equal "
        f"{torch.equal(mask_k, mask_p)}; state max_abs_err {err:.3e} limit {limit:.3e}")
    if not (torch.equal(mask_k, mask_p) and err <= limit):
        fail("the limited Z4+GRHD kernel path disagrees with the plain path")
    del mask_k, mask_p, step_k, step_p
    phase("the main path and the plain step")

    # ------------------------------------------- K3 a on the main path's batch, float32
    candidate = cu.step(uw, Z4_DT)
    tables = plain._gather_tables_row(plain.troubled_mask(uw, candidate))
    n_active = int(tables["n_active"])
    del candidate
    recorded = record_sweeps(plain, uw, Z4_DT, tables)
    sweep_shape = tuple(recorded[0][1].shape)
    k3_err, k3_ms, k3_full_ms, k3_plain_ms = 0.0, {}, {}, {}
    n_dev, all_dev = tables["n_active"], torch.tensor(CAPACITY, device=dev)
    for d, s, lo, hi in recorded:
        ref = plain._row_sweep_math(s, lo, hi, d, Z4_DT)
        label = f"{sweep_shape} (gathered batch after {Z4M_WARMUP} steps)"
        k3_err = max(k3_err, k3_check(torch, subcell_cuda, lim, d, s, lo, hi, n_active, ref,
                                      label, dt=Z4_DT, name=kernel))
        k3_check(torch, subcell_cuda, lim, d, s, lo, hi, CAPACITY, ref, label, dt=Z4_DT,
                 name=kernel)
        work = s.clone()

        def sweep(n_):
            return subcell_cuda.row_sweep_call(lim, d, work, lo, hi, Z4_DT, n_)

        # CUDA events over back-to-back calls: a sweep of 43 variables
        # outlasts the wrapper's host time (torch.profiler recorded no span
        # of it with every slot active on an H100).
        k3_ms[d] = event_ms(torch, lambda: sweep(n_dev), 5)
        work.copy_(s)
        k3_full_ms[d] = event_ms(torch, lambda: sweep(all_dev), 3)
        k3_plain_ms[d] = once_ms(torch, lambda: plain._row_sweep_math(s, lo, hi, d, Z4_DT))
        del ref, work
    s_last = recorded[-1][1]
    source_ms = event_ms(torch, lambda: sol.source_fn(s_last, va), 3)
    del recorded, s, lo, hi, s_last
    torch.cuda.empty_cache()
    phase("K3 a in float32 at full width")

    # ------------------------------------------- times
    dofs = sol.dofs()
    k_win = windows(torch, lim, uw, Z4_DT, steps=TIME_STEPS)
    ms = [1e3 * w for w in k_win]
    say(f"[z4l time] kernel path: step ms per window {ms!r}; median {statistics.median(ms)!r} "
        f"ms, {dofs / statistics.median(k_win)!r} DOF-updates/s ({dofs} DOF per step); plain "
        f"path one step {plain_step_ms!r} ms (the main path's, CUDA events; {card})")
    cand, dg_fl = cu.step(uw, Z4_DT, return_face_fluxes=True)
    raw = lim.troubled_mask(uw, cand)
    tab = lim._gather_tables_row(raw)
    R, g = lim._gathered_subcell_step_row(uw, Z4_DT, tab)
    fv = lim._scatter_face_fluxes_row(g, tab, uw.dtype)
    matched = lim._match_interface_fluxes(cand, dg_fl, fv, tab["mask"], Z4_DT)
    merged = lim._scatter_fallback_row(matched.clone(), R, tab, tab["mask"])
    stages = {
        "candidate (K1 d, face fluxes out)":
            lambda: cu.step(uw, Z4_DT, return_face_fluxes=True),
        "detection": lambda: lim.troubled_mask(uw, cand),
        "tables": lambda: lim._gather_tables_row(raw),
        "gathered fallback (projection, ghosts, 3 sweeps, source, reconstruction)":
            lambda: lim._gathered_subcell_step_row(uw, Z4_DT, tab),
        "matching (face-flux scatter and interface matching)": lambda: (
            lim._match_interface_fluxes(cand, dg_fl, lim._scatter_face_fluxes_row(
                g, tab, uw.dtype), tab["mask"], Z4_DT)),
        "merge and guard": lambda: lim._admissibility_scale(lim._scatter_fallback_row(
            matched, R, tab, tab["mask"])),
    }
    stage_ms = {k: event_ms(torch, fn, 3) for k, fn in stages.items()}
    step_ms = event_ms(torch, lambda: lim.step(uw, Z4_DT), 5)
    say(f"[z4l time] the step's stages alone (CUDA events, 3 calls each): " + ", ".join(
        f"{k} {v!r} ms" for k, v in stage_ms.items()) + f"; of the gathered fallback: the "
        f"sweeps {sum(k3_ms.values())!r} ms (CUDA events) at {n_active} active slots, the "
        f"source (plain source_fn on the batch {sweep_shape}) {source_ms!r} ms; whole step "
        f"{step_ms!r} ms ({card})")
    del cand, dg_fl, raw, tab, R, g, fv, matched, merged
    idle, busy, wall = idle_share(torch, lambda: lim.run(uw, TIME_STEPS, Z4_DT))
    say(f"[z4l idle] kernel path, {TIME_STEPS} steps under torch.profiler: device busy {busy!r} ms "
        f"of wall {wall!r} ms; idle share {idle!r} ({card})")
    say(f"[z4l mem] peak allocated over {STEPS} steps: kernel path {peak * gib:.4f} GiB, "
        f"plain step {plain_peak * gib:.4f} GiB ({card})")
    phase("the times")

    # ------------------------------------------- bounds
    itemsize = uw.element_size()
    per_pencil, parts = z4l_sweep_ops(torch, sol.rhs_all_fn)
    n_cells = sweep_shape[4] * sweep_shape[5]
    info = subcell_cuda.kernel_info(torch.float32, 0, "z4_matter")
    bnds = {}
    for what, nrows, ms_ in ((f"{n_active} active slots", n_active, k3_ms),
                             (f"all {CAPACITY} slots active", CAPACITY, k3_full_ms)):
        pencils = 25 * nrows * Z4_GRID[-1]
        bnds[what] = kernel_report(
            None, kernel, torch.float32, f"(limited Z4+GRHD, {what}) {sweep_shape} f32, mean "
            "of 3 directions", statistics.mean(ms_.values()),
            sweep_bytes(pencils, n_cells, itemsize, n_sub=5, nvar=43), per_pencil * pencils,
            card, info=info)
    bnd, bnd_full = bnds.values()
    say(f"[bound] {kernel} f32, one sweep: {per_pencil} operations a pencil ({parts}); "
        f"{n_active} active slots: kernel mean {statistics.mean(k3_ms.values())!r} ms (per "
        f"direction {list(k3_ms.values())!r}) against {bnd['bound_ms']!r} ms by "
        f"{bnd['bound_by']}; all {CAPACITY} slots active: kernel mean "
        f"{statistics.mean(k3_full_ms.values())!r} ms (per direction "
        f"{list(k3_full_ms.values())!r}) against {bnd_full['bound_ms']!r} ms by "
        f"{bnd_full['bound_by']}; plain sweep {list(k3_plain_ms.values())!r} ms ({card})")
    del sol, cu, lim, plain, u0, uw, u
    torch.cuda.empty_cache()
    return [{
        "name": kernel,
        "route": "cuda",
        "source": "exahype_tpu_torch/csrc/subcell_ncp.cuh",
        "replaces": "exahype_tpu/models/subcell_pallas.py:47",
        "launches": launches[kernel],
        "max_abs_err": k3_err,
        "ms": statistics.mean(k3_ms.values()),
        "plain_ms": statistics.mean(k3_plain_ms.values()),
        **bnd,
        "library_ms": None,  # no single PyTorch call computes it
    }]


def z4g_noisy(torch, sol, seed=5):
    """A parity state (``Z4G_NOISE``): ``pack_matter_mhd`` of flat space with
    seeded noise on every Z4 slot, ρ ≈ 1, p ≈ 1, a velocity field of up to
    0.15 a component, a field of 0.05 to 0.1 a component and a GLM scalar of
    ~1e-2, in ``sol``'s dtype on its device."""
    import numpy as np

    from exahype_tpu_torch.models.z4_grmhd import pack_matter_mhd

    va = sol.var_axis
    shape = sol.state_shape[:va] + sol.state_shape[va + 1:]
    rng = np.random.default_rng(seed)
    z4 = Z4G_NOISE * rng.standard_normal(shape + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    rho = 1.0 + 0.1 * rng.random(shape)
    p = 1.0 + 0.1 * rng.random(shape)
    v = 0.3 * (rng.random(shape + (3,)) - 0.5)
    B = 0.05 * (1.0 + rng.random(shape + (3,)))
    psi = 0.01 * rng.standard_normal(shape)
    q = pack_matter_mhd(*(torch.from_numpy(x) for x in (z4, rho, v, p, B)),
                        psi_glm=torch.from_numpy(psi))
    return q.movedim(-1, va).to(device=sol.weights.device, dtype=sol.weights.dtype).contiguous()


def z4g_totals(torch, sol, u) -> tuple[list[float], float]:
    """``([∫D̃ dV, ∫B̃^x dV, ∫B̃^y dV, ∫B̃^z dV], ∫|B̃| dV)`` over the grid
    (:func:`z4m_integral`; |B̃| the Euclidean norm of the three slots)."""
    va = sol.var_axis
    totals = [z4m_integral(torch, sol, u, slot) for slot in (38, 43, 44, 45)]
    norm = u.narrow(va, 43, 3).double().norm(dim=va, keepdim=True)
    return totals, float((norm * node_weights(torch, sol, u)).sum()) * math.prod(sol._dxs)


def z4_grmhd_path(torch, dev, card) -> list[dict]:
    """The Z4+GRMHD path: the 47-variable coupled step through ``CudaADERDG``
    (K1 d's conservative-flux variant over the magnetized system,
    ``csrc/aderdg_z4_grmhd.cu``) and the ``with_cuda_rhs`` route (K5 e,
    ``rhs_all_z4_grmhd``); returns their lines of the kernel JSON."""
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4_grmhd import (
        magnetized_wave_state,
        make_z4_grmhd_solver,
        z4_grmhd_admissible,
    )
    from exahype_tpu_torch.models.z4_matter import make_z4_matter_solver

    def make(grid, dtype, **params):
        plain = make_z4_grmhd_solver(3, Z4_ORDER, grid, dx=Z4_DX, fused_rhs="soa", device=dev,
                                     dtype=dtype, **params)
        return plain, with_cuda_rhs(plain)

    admissible = z4_grmhd_admissible(gamma=Z4G_PARAMS["gamma"], iters=Z4G_PARAMS["iters"])
    t0 = time.perf_counter()

    def phase(what):
        say(f"[z4g] {what}: {time.perf_counter() - t0:.1f} s into the path (host clock)")

    # ------------------------------------------- kernels vs plain, float64, cut grid
    for params in Z4G_FAMILIES:
        plain64, kern64 = make(Z4_CUT, torch.float64, **params)
        k5_64 = kern64.rhs_all_fn
        which = f"{k5_64.inner.physics.params}"
        u = z4g_noisy(torch, plain64)
        if not bool(admissible(u, plain64.var_axis).all()):
            fail(f"the Z4+GRMHD parity state is not admissible ({which})")
        for i, (Q, grads, va) in enumerate(z4_rhs_calls(plain64, u, Z4_DT)):
            got, again = k5_64(Q, grads, va), k5_64(Q, grads, va)
            ref = plain64.rhs_all_fn(Q, grads, va)
            torch.cuda.synchronize()
            err = max_err(torch, got, ref)
            limit = Z4_F64_RTOL * max(1.0, ref.abs().max().item())
            ok = err <= limit and torch.equal(got, again)
            name = z4_call_name(i, plain64.picard_iters)
            say(f"[z4g parity] rhs_all_z4_grmhd float64 {Z4_CUT} magnetized fluid, noisy Z4 "
                f"slots (slicing, f, m, κ₁, κ₂, Γ, iters, c_h, κ) = {which} {name} "
                f"{tuple(Q.shape)}: max_abs_err {err:.3e} limit {limit:.3e} ({Z4_F64_RTOL:.0e} "
                f"x max(1, max|plain| = {ref.abs().max().item():.4g})); repeat bitwise "
                f"{torch.equal(got, again)} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K5 e (float64, {which}, {name}) disagrees with its plain version")
        step_k, step_p = kern64.step(u, Z4_DT), plain64.step(u, Z4_DT)
        err = max_err(torch, step_k, step_p)
        limit = Z4_F64_RTOL * max(1.0, step_p.abs().max().item())
        say(f"[z4g parity] one float64 step {Z4_CUT} {which} through with_cuda_rhs vs the plain "
            f"step: max_abs_err {err:.3e} limit {limit:.3e}; K5 e launches {k5_64.launches}")
        if not err <= limit:
            fail(f"the float64 Z4+GRMHD step through K5 e disagrees with the plain step ({which})")
        z4_kernel_parity(torch, plain64, CudaADERDG(plain64), u, Z4_DT, f"K1 d GRMHD {which}",
                         tag="z4g")
        del plain64, kern64, k5_64, u, got, again, ref, step_k, step_p

    phase("the float64 parity of two families")

    # ------------------------------------------- the zero-field cross-check, float64
    # B̃ = φ̃ = 0 on a Z4+GRHD state: the first 43 rows of one kernel step
    # are the Z4+GRHD kernels' step, to the recoveries' convergence.
    g64, _ = make(Z4_CUT, torch.float64, **dict(Z4G_PARAMS, c_h=Z4G_ZERO_FIELD_CH))
    m64 = make_z4_matter_solver(3, Z4_ORDER, Z4_CUT, dx=Z4_DX, fused_rhs="soa", device=dev,
                                dtype=torch.float64, **Z4M_PARAMS)
    va = m64.var_axis
    um = z4m_noisy(torch, m64)
    ug = torch.cat([um, torch.zeros_like(um.narrow(va, 0, 4))], dim=va).contiguous()
    cug, cum = CudaADERDG(g64), CudaADERDG(m64)
    sg, sm = cug.step(ug, Z4_DT), cum.step(um, Z4_DT)
    torch.cuda.synchronize()
    rtol, atol = Z4G_ZERO_FIELD_TOL
    head = sg.narrow(va, 0, 43)
    err = max_err(torch, head, sm)
    excess = ((head - sm).abs() - rtol * sm.abs()).max().item()
    field = sg.narrow(va, 43, 4).abs().max().item()
    ok = excess <= atol and field == 0.0
    say(f"[z4g zero field] float64 {Z4_CUT}, B̃ = φ̃ = 0 on the Z4+GRHD parity state, c_h = "
        f"{Z4G_ZERO_FIELD_CH} (under the cone): one step through CudaADERDG(Z4+GRMHD) vs "
        f"CudaADERDG(Z4+GRHD), rows 0-42: max_abs_err {err:.3e}, max(|a − b| − {rtol:g}|b|) "
        f"{excess:.3e} (limit {atol:g}); max|B̃, φ̃| after the step {field!r}; launches "
        f"{cug.launches} and {cum.launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("with B̃ = φ̃ = 0 the Z4+GRMHD kernel step is not the Z4+GRHD kernel step")
    del g64, m64, um, ug, cug, cum, sg, sm, head
    phase("the zero-field cross-check")

    # ------------------------------------------- kernels vs plain, float32, full width
    plain, kern = make(Z4_GRID, torch.float32, **Z4G_PARAMS)
    sol64, _ = make(Z4_GRID, torch.float64, **Z4G_PARAMS)
    cu = CudaADERDG(plain)
    k5 = kern.rhs_all_fn
    iters = plain.picard_iters
    va = plain.var_axis
    u0 = magnetized_wave_state(plain, B0=Z4G_B0, amp=Z4G_AMP).contiguous()
    un = z4g_noisy(torch, plain)
    ncell = math.prod(Z4_GRID)
    dofs = plain.dofs()
    cfl = float(plain.cfl_dt(u0))
    say(f"[z4g] {Z4_GRID} cells, order {Z4_ORDER}, 47 vars, {Z4G_PARAMS}; the magnetized wave "
        f"(B0 = {Z4G_B0}, amplitude {Z4G_AMP}, one period along axis 0): {dofs} DOF, state "
        f"{u0.nbytes} B f32; dt = {Z4_DT!r}; cfl_dt(initial state) = {cfl!r} (dt / cfl_dt = "
        f"{Z4_DT / cfl!r}); picard_iters {iters}")
    if Z4_DT > cfl:
        fail(f"dt = {Z4_DT} is over the Z4+GRMHD state's CFL limit {cfl}")
    if not bool(admissible(u0, va).all()):
        fail("the magnetized wave is not admissible")
    calls = z4_rhs_calls(plain, un, Z4_DT)
    k5_err = 0.0
    for i in (0, iters):  # the Picard shape, the corrector's
        Q, grads, va_ = calls[i]
        got = k5(Q, grads, va_)
        ref = plain.rhs_all_fn(Q, grads, va_)
        ref64 = plain.rhs_all_fn(Q.double(), tuple(g.double() for g in grads), va_)
        torch.cuda.synchronize()
        err, limit = max_err(torch, got, ref), f32_bound(torch, ref)
        to64_k, to64_p = max_err(torch, got, ref64), max_err(torch, ref, ref64)
        ok = err <= limit
        say(f"[z4g parity] rhs_all_z4_grmhd float32 {Z4_GRID} magnetized fluid, noisy Z4 slots "
            f"{z4_call_name(i, iters)} {tuple(Q.shape)}: max_abs_err {err:.3e} limit "
            f"{limit:.3e} ({F32_ULPS} f32 spacings of max|plain| = {ref.abs().max().item():.4g}) "
            f"{'ok' if ok else 'FAIL'}; against the float64 plain result: kernel {to64_k:.3e}, "
            f"plain float32 {to64_p:.3e}")
        if not ok:
            fail(f"K5 e (float32, {z4_call_name(i, iters)}) disagrees with its plain version")
        k5_err = max(k5_err, err)
        del got, ref, ref64
    del calls
    plain_times = {}  # the plain stages' times, as the parity call runs them
    k1d_errs = z4_kernel_parity(torch, plain, cu, un, Z4_DT, "K1 d GRMHD, the path's own",
                                sol64, tag="z4g", plain_ms=plain_times)
    del un, sol64
    torch.cuda.empty_cache()
    phase("the float32 parity at full width")

    # ------------------------------------------- the main path: CudaADERDG
    gib = 2.0**-30
    uw = cu.run(u0, Z4G_WARMUP, Z4_DT)
    totals0, field0 = z4g_totals(torch, plain, uw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cu.reset_launches()
    u_d = cu.run(uw, STEPS, Z4_DT)
    torch.cuda.synchronize()
    d_launches = dict(cu.launches)
    d_peak = torch.cuda.max_memory_allocated()
    say(f"[z4g main] {Z4G_WARMUP} warm-up steps, then {STEPS} steps of {Z4_GRID} f32 through "
        f"CudaADERDG(make_z4_grmhd_solver(..., fused_rhs='soa')): launches {d_launches} "
        f"(expected {STEPS} of each: 3 a step); peak {d_peak * gib:.4f} GiB allocated "
        f"({held * gib:.4f} GiB held before) ({card})")
    if d_launches != {name: STEPS for name in cu.kernels}:
        fail(f"the Z4+GRMHD step through CudaADERDG launched {d_launches} in {STEPS} steps, "
             "expected 3 a step")
    if tuple(u_d.shape) != plain.state_shape or not torch.isfinite(u_d).all():
        fail("the Z4+GRMHD state through CudaADERDG is not finite or has the wrong shape")
    if not bool(admissible(u_d, va).all()):
        fail("the Z4+GRMHD state through CudaADERDG is not admissible")
    totals1, _ = z4g_totals(torch, plain, u_d)
    drifts = [abs(totals1[0] - totals0[0]) / abs(totals0[0])]
    drifts += [abs(b - a) / field0 for a, b in zip(totals0[1:], totals1[1:])]
    say(f"[z4g main] CudaADERDG over {STEPS} steps: ∫D̃ dV {totals0[0]!r} -> {totals1[0]!r}, "
        f"drift {drifts[0]!r}; ∫B̃^i dV {totals0[1:]!r} -> {totals1[1:]!r}, drift against "
        f"∫|B̃| dV = {field0!r}: {drifts[1:]!r} (gate {Z4G_DRIFT}); admissible "
        "(z4_grmhd_admissible) at every node")
    if not max(drifts) <= Z4G_DRIFT:
        fail(f"∫D̃ or ∫B̃^i dV drifted by {drifts} over {STEPS} Z4+GRMHD steps through CudaADERDG")
    if not torch.equal(u_d, cu.run(uw, STEPS, Z4_DT)):
        fail("two Z4+GRMHD runs through CudaADERDG from the same state differ")
    say("[z4g main] CudaADERDG: two runs from the same state: bitwise equal")

    # ------------------------------------------- the with_cuda_rhs route (K5 e)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5.reset_launches()
    u_k = kern.run(uw, Z4_EAGER_STEPS, Z4_DT)
    torch.cuda.synchronize()
    launches = k5.launches
    peak = torch.cuda.max_memory_allocated()
    want = (iters + 2) * Z4_EAGER_STEPS
    say(f"[z4g main] {Z4_EAGER_STEPS} steps of {Z4_GRID} f32 through make_z4_grmhd_solver + "
        f"with_cuda_rhs: K5 e launches {launches} (expected (picard_iters + 2) x steps = "
        f"{want}); peak {peak * gib:.4f} GiB allocated ({card})")
    if launches != want:
        fail(f"K5 e launched {launches} times in {Z4_EAGER_STEPS} Z4+GRMHD steps, expected "
             f"{want}")
    if tuple(u_k.shape) != plain.state_shape or not torch.isfinite(u_k).all():
        fail("the Z4+GRMHD state through with_cuda_rhs is not finite or has the wrong shape")
    if not bool(admissible(u_k, va).all()):
        fail("the Z4+GRMHD state through with_cuda_rhs is not admissible")
    # The plain path over as many steps; the kernel path after 1 and after
    # them, within that many f32 bounds.
    torch.cuda.reset_peak_memory_stats()
    p1 = plain.step(uw, Z4_DT)
    pn = plain.run(p1, Z4_EAGER_STEPS - 1, Z4_DT)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    d1, dn = cu.step(uw, Z4_DT), cu.run(uw, Z4_EAGER_STEPS, Z4_DT)
    for route, n, a, b in (("CudaADERDG", 1, d1, p1), ("CudaADERDG", Z4_EAGER_STEPS, dn, pn),
                           ("with_cuda_rhs", Z4_EAGER_STEPS, u_k, pn)):
        err, limit = max_err(torch, a, b), n * f32_bound(torch, b)
        say(f"[z4g main] {route}, {n} step(s), kernel path vs plain path: max_abs_err "
            f"{err:.3e} limit {limit:.3e}")
        if not err <= limit:
            fail(f"the Z4+GRMHD kernel path ({route}) disagrees with the plain path after "
                 f"{n} step(s)")
    del d1, dn, p1
    phase("the main runs and the plain path")

    # Readings: the constraint sector (Θ, Z), the field the flow bends
    # (B̃^y, zero at first), the cleaning scalar.
    t_d = (Z4G_WARMUP + STEPS) * Z4_DT
    t_e = (Z4G_WARMUP + Z4_EAGER_STEPS) * Z4_DT
    for label, t, x in (("CudaADERDG path", t_d, u_d), ("with_cuda_rhs path", t_e, u_k),
                        ("plain path", t_e, pn)):
        th = x.narrow(va, 13, 1).double().abs().max().item()
        zz = x.narrow(va, 14, 3).double().abs().max().item()
        by = x.narrow(va, 44, 1).double().abs().max().item()
        psi = x.narrow(va, 46, 1).double().abs().max().item()
        totals, _ = z4g_totals(torch, plain, x)
        say(f"[z4g reading] {label} at t = {t!r} from the magnetized wave: max|Θ| {th!r}, "
            f"max|Z_i| {zz!r}, max|B̃^y| {by!r}, max|φ̃| {psi!r}, ∫(D̃, B̃^x, B̃^y, B̃^z) dV "
            f"{totals!r}")
    del pn, u_k, u_d
    phase("the readings")

    # ------------------------------------------- times
    d_win = windows(torch, cu, u0, Z4_DT, steps=10)
    k_win = windows(torch, kern, u0, Z4_DT, steps=1, n_windows=1)
    p_win = windows(torch, plain, u0, Z4_DT, steps=1, n_windows=1)
    for label, win in (("CudaADERDG path", d_win), ("with_cuda_rhs path", k_win),
                       ("plain path", p_win)):
        ms = [1e3 * w for w in win]
        say(f"[z4g time] {label}: step ms per window {ms!r}; median {statistics.median(ms)!r} "
            f"ms, {dofs / statistics.median(win)!r} DOF-updates/s ({dofs} DOF per step; {card})")
    new, faces, _ = cu.predictor_volume(u0, Z4_DT)
    fhat, fhalf = cu.face_flux(faces)
    pred, flux, update = cu.kernels
    d_times = {  # the plain stages' times: their full-width parity call's
        pred: (event_ms(torch, lambda: cu.predictor_volume(u0, Z4_DT), 20), plain_times[pred]),
        flux: (event_ms(torch, lambda: cu.face_flux(faces), 20), plain_times[flux]),
        update: (event_ms(torch, lambda: cu.surface_update(new, fhat, Z4_DT, fhalf=fhalf), 20),
                 plain_times[update]),
        "face stage": (event_ms(torch, lambda: cu.face_surface(new, faces, Z4_DT), 20),
                       plain_times["face stage"]),
        "step": (event_ms(torch, lambda: cu.step(u0, Z4_DT), 20),
                 1e3 * p_win[0]),  # the plain step's host window above
    }
    for name, (ms, plain_ms) in d_times.items():
        say(f"[z4g time] K1 d GRMHD {name}: kernel {ms!r} ms, plain {plain_ms!r} ms (CUDA "
            f"events; the plain step's: its host window; {card})")
    calls = z4_rhs_calls(plain, u0, Z4_DT)
    pic, cor = calls[0], calls[iters]
    del calls
    k5_ms = {
        "Picard": event_ms(torch, lambda: k5(*pic), 20),
        "corrector": event_ms(torch, lambda: k5(*cor), 20),
    }
    k5_plain_ms = {
        "Picard": event_ms(torch, lambda: plain.rhs_all_fn(*pic), 2),
        "corrector": event_ms(torch, lambda: plain.rhs_all_fn(*cor), 2),
    }
    say(f"[z4g time] K5 e per launch (CUDA events, 20 launches): Picard shape "
        f"{tuple(pic[0].shape)} {k5_ms['Picard']!r} ms, corrector shape {tuple(cor[0].shape)} "
        f"{k5_ms['corrector']!r} ms; plain rhs_all_fn {k5_plain_ms['Picard']!r} / "
        f"{k5_plain_ms['corrector']!r} ms ({card})")
    phase("the times before the idle shares")
    idle, busy, wall = idle_share(torch, lambda: cu.run(u0, 20, Z4_DT))
    say(f"[z4g idle] CudaADERDG path, 20 steps under torch.profiler: device busy {busy!r} ms of "
        f"wall {wall!r} ms; idle share {idle!r} ({card})")
    say(f"[z4g mem] peak allocated: CudaADERDG path over {STEPS} steps {d_peak * gib:.4f} GiB, "
        f"with_cuda_rhs path over {Z4_EAGER_STEPS} {peak * gib:.4f} GiB, plain path over "
        f"{Z4_EAGER_STEPS} {plain_peak * gib:.4f} GiB ({card})")
    phase("the times")

    # ------------------------------------------- bounds
    counts = z4_point_ops(torch, plain.rhs_all_fn)
    per_point = sum(counts.values())
    q_slots, grad_slots = z4_slots_read(torch, plain.rhs_all_fn)
    bounds = {}
    for name, (Q, _, va_) in (("Picard", pic), ("corrector", cor)):
        points = Q.numel() // Q.shape[va_]
        n_bytes = Q.element_size() * points * (q_slots + grad_slots + Q.shape[va_])
        bounds[name] = bound(n_bytes, per_point * points)
        say(f"[bound] rhs_all_z4_grmhd {name} shape {tuple(Q.shape)} f32: {per_point} "
            f"operations a point ({counts}, counted on the plain algebra, the recovery's "
            f"{Z4G_PARAMS['iters']} Newton trips included), {points} points, {n_bytes} B "
            f"({q_slots} state slots and {grad_slots} gradient slots read, as the plain algebra "
            f"reads them, {Q.shape[va_]} written): bound {bounds[name]['bound_ms']!r} ms by "
            f"{bounds[name]['bound_by']}; kernel {k5_ms[name]!r} ms ({card})")
    full = z4_value_ops(torch, plain.rhs_all_fn)
    zero = z4_value_ops(torch, plain.rhs_all_fn, ())
    axes = [z4_value_ops(torch, plain.rhs_all_fn, (k,)) for k in range(3)]
    say(f"[bound] the Z4+GRMHD algebra's operations at a point with no zero state slot "
        f"(z4_value_ops): every gradient axis {full}, none {zero}, one {axes}; gradient slots "
        f"read {grad_slots // 3} an axis (the plain count on flat space at rest with zero "
        f"gradients is {per_point}); the matter flux of the three axes {Z4G_FLUX_OPS} beside "
        "the shared recovery")
    work = z4_kernel_work(Z4_ORDER, iters, ncell, u0.element_size(), full, zero,
                          sum(axes) / 3, v=plain.n_vars, gs=grad_slots // 3,
                          eig_ops=Z4G_EIG_OPS, suffix="z4_grmhd", hydro=9,
                          flux_ops=Z4G_FLUX_OPS)
    work["face stage"] = tuple(a + b for a, b in zip(work[flux], work[update]))
    lines = []
    for name in (pred, flux, update, "face stage"):
        bnd = kernel_report(None if name == "face stage" else cu, name, torch.float32,
                            f"(Z4+GRMHD) {Z4_GRID} f32", d_times[name][0], *work[name], card)
        if name == "face stage":
            continue
        lines.append(kernel_line(f"{name} (Z4+GRMHD, K1 d)",
                                 "exahype_tpu/models/aderdg_pallas.py:156", d_launches[name],
                                 k1d_errs[name], *d_times[name], bnd,
                                 "exahype_tpu_torch/csrc/aderdg_z4.cuh"))
    del kern, plain, cu, u0, uw, pic, cor, new, faces, fhat, fhalf
    torch.cuda.empty_cache()
    return lines + [{
        "name": "rhs_all_z4_grmhd",
        "route": "cuda",
        "source": "exahype_tpu_torch/csrc/rhs.cu",
        "replaces": "exahype_tpu/models/rhs_pallas.py:104",
        "launches": launches,
        "max_abs_err": k5_err,
        "ms": k5_ms["Picard"],
        "plain_ms": k5_plain_ms["Picard"],
        **bounds["Picard"],
        "library_ms": None,  # no single PyTorch call computes it
    }]


def z4_forms_path(torch, dev, card) -> list[dict]:
    """The vacuum Z4 step as the JAX package builds it by default (the
    per-axis NCP, ``fused_rhs=False``) and in 2-D, through ``CudaADERDG``:
    K1 d's per-axis predictor on the 3-D cell (``csrc/aderdg_z4_per_axis.cu``,
    with the fused step's face pair) and the 2-D steps at orders 2 and 3,
    fused and per-axis (``csrc/aderdg_z4_2d.cu``, ``aderdg_z4_2d_p3.cu``);
    ``examples/z4_gauge_wave.py`` on its chip grid and in its CPU
    configuration.  Returns their lines of the kernel JSON."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver, solver_constraints

    def make(form, grid, dtype, dx):
        dim, order, fused = form
        return make_z4_solver(dim, order, grid, dx=dx, impl="soa", fused_rhs=fused, device=dev,
                              dtype=dtype)

    def noisy(sol, seed):
        u = gauge_wave_state(sol, amplitude=Z4_AMPLITUDE)
        noise = np.random.default_rng(seed).standard_normal(tuple(u.shape))
        return (u + Z4F_NOISE * torch.from_numpy(noise).to(u)).contiguous()

    def label(form):
        dim, order, fused = form
        return f"{dim}-D p{order} {'fused' if fused else 'per-axis'}"

    # ------------------------------------------- kernels vs plain, float64, cut grids
    for i, form in enumerate(Z4F_FORMS):
        grid, dx = (Z4F_CUT, Z4F_CUT_DX) if form[0] == 2 else (Z4_CUT, Z4_DX)
        sol64 = make(form, grid, torch.float64, dx)
        z4_kernel_parity(torch, sol64, CudaADERDG(sol64), noisy(sol64, 10 + i), Z4_DT,
                         label(form), tag="z4f")
        del sol64
    torch.cuda.empty_cache()

    # ------------------------------------------- float32 at full width: parity,
    # the main path (3 launches a step, repeatable), times
    gib = 2.0**-30
    launches, errs, plain_ms, ms, work, info, counts = {}, {}, {}, {}, {}, {}, {}
    for i, form in enumerate(Z4F_FORMS):
        dim, order, fused = form
        grid, dx = (Z4F_GRID, 1.0 / Z4F_GRID[0]) if dim == 2 else (Z4_GRID, Z4_DX)
        sol = make(form, grid, torch.float32, dx)
        cu = CudaADERDG(sol)
        u0 = noisy(sol, 20 + i)
        sol64 = make(form, grid, torch.float64, dx)
        times = {}
        for name, err in z4_kernel_parity(torch, sol, cu, u0, Z4_DT, f"{label(form)}, full width",
                                          sol64, tag="z4f", plain_ms=times).items():
            errs[name] = max(errs.get(name, 0.0), err)
        for name, t in times.items():
            plain_ms.setdefault(name, t)
        del sol64
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cu.reset_launches()
        u = cu.run(u0, Z4F_STEPS, Z4_DT)
        torch.cuda.synchronize()
        got = dict(cu.launches)
        say(f"[z4f main] {label(form)} {grid} f32 ({sol.dofs()} DOF): {Z4F_STEPS} steps through "
            f"CudaADERDG: launches {got} (expected {Z4F_STEPS} of each: 3 a step); peak "
            f"{torch.cuda.max_memory_allocated() * gib:.4f} GiB allocated ({card})")
        if got != {name: Z4F_STEPS for name in cu.kernels}:
            fail(f"the {label(form)} Z4 step launched {got} in {Z4F_STEPS} steps, expected 3 a "
                 "step")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
            fail(f"the {label(form)} Z4 state is not finite or has the wrong shape")
        if not torch.equal(u, cu.run(u0, Z4F_STEPS, Z4_DT)):
            fail(f"two {label(form)} Z4 runs from the same state differ")
        win = [1e3 * w for w in windows(torch, cu, u0, Z4_DT, steps=Z4F_STEPS)]
        say(f"[z4f time] {label(form)} {grid} f32 step: ms per window {win!r}; median "
            f"{statistics.median(win)!r} ms, {sol.dofs() / statistics.median(win) * 1e3!r} "
            f"DOF-updates/s; runs bitwise equal ({card})")
        new, faces, _ = cu.predictor_volume(u0, Z4_DT)
        fhat, fhalf = cu.face_flux(faces)
        pred, flux, update = cu.kernels
        ms[pred] = event_ms(torch, lambda: cu.predictor_volume(u0, Z4_DT), 10)
        if dim == 2 and flux not in ms:  # each 2-D pair once (the 3-D pair is the Z4 path's)
            ms[flux] = event_ms(torch, lambda: cu.face_flux(faces), 20)
            ms[update] = event_ms(
                torch, lambda: cu.surface_update(new, fhat, Z4_DT, fhalf=fhalf), 20)
        say(f"[z4f time] {label(form)} kernels (CUDA events): " + ", ".join(
            f"{name} {ms[name]!r} ms (plain {plain_ms[name]!r} ms)" for name in cu.kernels
            if name in ms) + f" ({card})")
        if dim == 3:  # the fused step on the same state
            fcu = CudaADERDG(make((3, 2, "soa"), grid, torch.float32, dx))
            fwin = [1e3 * w for w in windows(torch, fcu, u0, Z4_DT, steps=Z4F_STEPS)]
            fpred = event_ms(torch, lambda: fcu.predictor_volume(u0, Z4_DT), 10)
            say(f"[z4f time] 3-D p2 on the same state: per-axis step median "
                f"{statistics.median(win)!r} ms, predictor {ms[pred]!r} ms; fused step "
                f"{statistics.median(fwin)!r} ms (windows {fwin!r}), predictor {fpred!r} ms "
                f"({card})")
            del fcu
        if form == (2, 2, "soa"):  # K5 b's with_cuda_rhs route on the same state
            kern = with_cuda_rhs(sol)
            k5 = kern.rhs_all_fn
            k5.reset_launches()
            eager, eager_ms = timed_once(torch, lambda: kern.step(u0, Z4_DT))
            ref = cu.step(u0, Z4_DT)
            say(f"[z4f time] 2-D p2 fused {grid}: one eager step of the with_cuda_rhs route "
                f"(K5 b, {k5.launches} launches) {eager_ms!r} ms against CudaADERDG's "
                f"{statistics.median(win)!r} ms; max |difference| {max_err(torch, eager, ref)!r} "
                f"(f32 bound {f32_bound(torch, ref)!r}) ({card})")
            del kern, k5, eager, ref
        # Bounds: the algebra's operations (on the fused solver's hook, the
        # same algebra; they depend on the dimension only) and the cell's
        # counts.
        if dim not in counts:
            hook = make((dim, order, "soa"), (1,) * dim, torch.float64, dx).rhs_all_fn
            axes = tuple(range(dim))
            counts[dim] = (z4_value_ops(torch, hook, axes), z4_value_ops(torch, hook, ()),
                           sum(z4_value_ops(torch, hook, (k,)) for k in axes) / dim,
                           sum(z4_ncp_ops(torch, hook, k) for k in axes))
            say(f"[bound] {dim}-D: the algebra's operations at a point (z4_value_ops): every "
                f"axis {counts[dim][0]}, none {counts[dim][1]}, one {counts[dim][2]!r}; the "
                f"{dim} NCP products together (z4_ncp_ops) {counts[dim][3]}")
        full, zero, one_axis, ncp = counts[dim]
        w = z4_kernel_work(order, sol.picard_iters, math.prod(grid), 4, full, zero, one_axis,
                           dim=dim, ncp=None if fused else ncp, names=cu.kernels)
        for name in cu.kernels:
            if name in ms and name not in work:
                work[name] = w[name]
                info[name] = (cu, f"{label(form)} {grid} f32")
        del sol, cu, u0, u, new, faces, fhat, fhalf
        torch.cuda.empty_cache()

    # ------------------------------------------- examples/z4_gauge_wave.py
    for cells, dtype_name in Z4X_CASES:
        dtype = getattr(torch, dtype_name)
        err_gate, c_gate = Z4X_GATES[cells]
        gated = (cells, dtype_name) != (64, "float32")  # the Queue 3 caveat
        grid, steps = (cells, 2), 4 * cells
        dt = Z4X_T / steps
        sol = make((2, 3, False), grid, dtype, 1.0 / cells)
        sol64 = make((2, 3, False), grid, torch.float64, 1.0 / cells)
        cu = CudaADERDG(sol)
        u0 = gauge_wave_state(sol, amplitude=Z4X_AMPLITUDE)
        cu.reset_launches()
        u, trail = u0, []
        for k in range(8):  # the run in eighths, reading the constraint after each
            u = cu.run(u, steps // 8, dt)
            H, M = solver_constraints(sol64, u.double())
            trail.append(max(H.abs().max().item(), M.abs().max().item()))
        torch.cuda.synchronize()
        got = dict(cu.launches)
        if got != {name: steps for name in cu.kernels}:
            fail(f"the example's run launched {got} in {steps} steps, expected 3 a step")
        if dtype == torch.float32:
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
        exact = gauge_wave_state(sol64, t=Z4X_T, amplitude=Z4X_AMPLITUDE)
        err = (u.double() - exact).pow(2).mean().sqrt().item()
        cmax = trail[-1]
        ok = err < err_gate and cmax < c_gate and bool(torch.isfinite(u).all())
        verdict = ("ok" if ok else "FAIL") if gated else (
            "a reading: over the gates in both packages, ROADMAP.md Queue 3" if not ok
            else "within the gates")
        say(f"[z4f example] examples/z4_gauge_wave.py, order 3 per-axis, {grid} {dtype_name}, "
            f"{steps} steps to t = {Z4X_T} through CudaADERDG ({got}): L2 error against the "
            f"exact wave {err!r} (gate {err_gate}), max ADM constraint {cmax!r} (gate {c_gate}; "
            f"after each eighth of the run {trail!r}) {verdict}")
        if gated and not ok:
            fail(f"the example's gates fail on the kernels ({grid}, {dtype_name})")
        a = cu.run(u0, Z4X_PLAIN_STEPS, dt)
        b = sol.run(u0, Z4X_PLAIN_STEPS, dt)
        limit = (Z4_F64_RTOL * max(1.0, b.abs().max().item()) if dtype == torch.float64
                 else Z4X_PLAIN_STEPS * f32_bound(torch, b))
        say(f"[z4f example] {grid} {dtype_name}, {Z4X_PLAIN_STEPS} steps, kernel path vs plain "
            f"path: max_abs_err {max_err(torch, a, b):.3e} limit {limit:.3e}")
        if not max_err(torch, a, b) <= limit:
            fail(f"the example's kernel path disagrees with the plain path ({grid})")
        del sol, sol64, cu, u0, u, exact, H, M, a, b

    # ------------------------------------------- reports and the JSON lines
    lines = []
    for name, (n_bytes, n_ops) in work.items():
        cu, where = info[name]
        bnd = kernel_report(cu, name, torch.float32, where, ms[name], n_bytes, n_ops, card)
        lines.append(kernel_line(f"{name} (vacuum Z4, K1 d)",
                                 "exahype_tpu/models/aderdg_pallas.py:156", launches[name],
                                 errs[name], ms[name], plain_ms[name], bnd,
                                 "exahype_tpu_torch/csrc/aderdg_z4.cuh"))
    missing = [name for name in work if not launches.get(name)]
    if missing:
        fail(f"kernels of the per-axis and 2-D Z4 path never launched: {missing}")
    return lines


def z4m_forms_path(torch, dev, card) -> list[dict]:
    """The Z4+GRHD step as the JAX package builds it by default (the
    per-axis NCP, ``fused_rhs=False``) in 3-D and 2-D, and its fused 2-D
    step, through ``CudaADERDG``: K1 d's per-axis predictor with the flux on
    the 3-D cell (``csrc/aderdg_z4_matter_per_axis.cu``, with the fused
    Z4+GRHD step's face pair) and the 2-D step at order 2, fused and
    per-axis (``csrc/aderdg_z4_matter_2d.cu``); K5 b's Z4+GRHD instance
    (``rhs_all_z4_matter_2d``) under the 2-D fused solver's ``with_cuda_rhs``
    route; ``examples/flrw_cosmology.py`` in its configuration and on its
    chip grid.  Returns their lines of the kernel JSON."""
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4_matter import (
        flrw_reference,
        flrw_state,
        make_z4_matter_solver,
    )

    def make(form, grid, dtype, dx, params=Z4M_PARAMS):
        dim, fused = form
        return make_z4_matter_solver(dim, Z4_ORDER, grid, dx=dx, fused_rhs=fused, device=dev,
                                     dtype=dtype, **params)

    def label(form):
        dim, fused = form
        return f"Z4+GRHD {dim}-D p2 {'fused' if fused else 'per-axis'}"

    t0 = time.perf_counter()

    def phase(what):
        say(f"[z4mf] {what}: {time.perf_counter() - t0:.1f} s into the path (host clock)")

    # ------------------------------------------- kernels vs plain, float64, cut grids
    k5_err = 0.0
    for params in Z4M_FAMILIES:  # the path's own parameters: float32 at full width below
        for form in Z4MF_FORMS:
            grid, dx = (Z4F_CUT, Z4F_CUT_DX) if form[0] == 2 else (Z4_CUT, Z4_DX)
            sol64 = make(form, grid, torch.float64, dx, params)
            u = z4m_noisy(torch, sol64)
            z4_kernel_parity(torch, sol64, CudaADERDG(sol64), u, Z4_DT, f"{label(form)} {params}",
                             tag="z4mf")
            if form == (2, "soa"):  # K5 b on every call of a step
                k5 = with_cuda_rhs(sol64).rhs_all_fn
                for i, (Q, grads, va) in enumerate(z4_rhs_calls(sol64, u, Z4_DT)):
                    got, again = k5(Q, grads, va), k5(Q, grads, va)
                    ref = sol64.rhs_all_fn(Q, grads, va)
                    torch.cuda.synchronize()
                    err = max_err(torch, got, ref)
                    limit = Z4_F64_RTOL * max(1.0, ref.abs().max().item())
                    ok = err <= limit and torch.equal(got, again)
                    say(f"[z4mf parity] {k5.kernel} float64 {grid} {params} "
                        f"{z4_call_name(i, sol64.picard_iters)} {tuple(Q.shape)}: max_abs_err "
                        f"{err:.3e} limit {limit:.3e}; repeat bitwise {torch.equal(got, again)} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"K5 b's Z4+GRHD instance disagrees with its plain version "
                             f"(float64, {z4_call_name(i, sol64.picard_iters)})")
                del k5, got, again, ref
            del sol64, u
    torch.cuda.empty_cache()
    phase("the float64 parity")

    # ------------------------------------------- float32 at full width: parity,
    # the main path (3 launches a step, repeatable), times
    launches, errs, plain_ms, ms, work, info, counts = {}, {}, {}, {}, {}, {}, {}
    for form in Z4MF_FORMS:
        dim, fused = form
        grid, dx = (Z4F_GRID, 1.0 / Z4F_GRID[0]) if dim == 2 else (Z4_GRID, Z4_DX)
        sol = make(form, grid, torch.float32, dx)
        cu = CudaADERDG(sol)
        sol64 = make(form, grid, torch.float64, dx)
        un = z4m_noisy(torch, sol)
        times = {}
        for name, err in z4_kernel_parity(torch, sol, cu, un, Z4_DT, f"{label(form)}, full width",
                                          sol64, tag="z4mf", plain_ms=times).items():
            errs[name] = max(errs.get(name, 0.0), err)
        for name, t in times.items():
            plain_ms.setdefault(name, t)
        del sol64
        u0, _ = z4m_flrw(torch, sol)
        cfl = float(sol.cfl_dt(u0))
        if Z4_DT > cfl:
            fail(f"dt = {Z4_DT} is over the {label(form)} state's CFL limit {cfl}")
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        cu.reset_launches()
        u = cu.run(u0, Z4F_STEPS, Z4_DT)
        torch.cuda.synchronize()
        got = dict(cu.launches)
        say(f"[z4mf main] {label(form)} {grid} f32 ({sol.dofs()} DOF), the perturbed FLRW slice, "
            f"dt = {Z4_DT} (cfl_dt {cfl!r}): {Z4F_STEPS} steps through CudaADERDG: launches "
            f"{got} (expected {Z4F_STEPS} of each: 3 a step) ({card})")
        if got != {name: Z4F_STEPS for name in cu.kernels}:
            fail(f"the {label(form)} step launched {got} in {Z4F_STEPS} steps, expected 3 a step")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
            fail(f"the {label(form)} state is not finite or has the wrong shape")
        if not torch.equal(u, cu.run(u0, Z4F_STEPS, Z4_DT)):
            fail(f"two {label(form)} runs from the same state differ")
        win = [1e3 * w for w in windows(torch, cu, u0, Z4_DT, steps=Z4F_STEPS)]
        say(f"[z4mf time] {label(form)} {grid} f32 step: ms per window {win!r}; median "
            f"{statistics.median(win)!r} ms, {sol.dofs() / statistics.median(win) * 1e3!r} "
            f"DOF-updates/s; runs bitwise equal ({card})")
        new, faces, _ = cu.predictor_volume(u0, Z4_DT)
        fhat, fhalf = cu.face_flux(faces)
        pred, flux, update = cu.kernels
        ms[pred] = event_ms(torch, lambda: cu.predictor_volume(u0, Z4_DT), 10)
        if dim == 2 and flux not in ms:  # the 2-D pair once (the 3-D pair is the Z4+GRHD path's)
            ms[flux] = event_ms(torch, lambda: cu.face_flux(faces), 20)
            ms[update] = event_ms(
                torch, lambda: cu.surface_update(new, fhat, Z4_DT, fhalf=fhalf), 20)
        say(f"[z4mf time] {label(form)} kernels (CUDA events): " + ", ".join(
            f"{name} {ms[name]!r} ms (plain {plain_ms[name]!r} ms)" for name in cu.kernels
            if name in ms) + f" ({card})")
        if dim == 3:  # the fused step on the same state
            fcu = CudaADERDG(make((3, "soa"), grid, torch.float32, dx))
            fwin = [1e3 * w for w in windows(torch, fcu, u0, Z4_DT, steps=Z4F_STEPS)]
            fpred = event_ms(torch, lambda: fcu.predictor_volume(u0, Z4_DT), 10)
            say(f"[z4mf time] Z4+GRHD 3-D p2 on the same state: per-axis step median "
                f"{statistics.median(win)!r} ms, predictor {ms[pred]!r} ms; fused step "
                f"{statistics.median(fwin)!r} ms (windows {fwin!r}), predictor {fpred!r} ms "
                f"({ms[pred] / fpred:.3f}x) ({card})")
            del fcu
        if form == (2, "soa"):  # K5 b's with_cuda_rhs route on the same state
            kern = with_cuda_rhs(sol)
            k5 = kern.rhs_all_fn
            iters = sol.picard_iters
            calls = z4_rhs_calls(sol, un, Z4_DT)
            for i in (0, iters):  # the Picard shape, the corrector's
                Q, grads, va = calls[i]
                got_k, ref = k5(Q, grads, va), sol.rhs_all_fn(Q, grads, va)
                ref64 = sol.rhs_all_fn(Q.double(), tuple(g.double() for g in grads), va)
                torch.cuda.synchronize()
                err, limit = max_err(torch, got_k, ref), f32_bound(torch, ref)
                say(f"[z4mf parity] {k5.kernel} float32 {grid} {z4_call_name(i, iters)} "
                    f"{tuple(Q.shape)}: max_abs_err {err:.3e} limit {limit:.3e} ({F32_ULPS} f32 "
                    f"spacings of max|plain| = {ref.abs().max().item():.4g}) "
                    f"{'ok' if err <= limit else 'FAIL'}; against the float64 plain result: "
                    f"kernel {max_err(torch, got_k, ref64):.3e}, plain float32 "
                    f"{max_err(torch, ref, ref64):.3e}")
                if not err <= limit:
                    fail(f"K5 b's Z4+GRHD instance (float32, {z4_call_name(i, iters)}) disagrees "
                         "with its plain version")
                k5_err = max(k5_err, err)
                del got_k, ref, ref64
            pic = calls[0]
            del calls
            k5.reset_launches()
            eager, eager_ms = timed_once(torch, lambda: kern.step(u0, Z4_DT))
            k5_launches = k5.launches
            ref = cu.step(u0, Z4_DT)
            if k5_launches != iters + 2:
                fail(f"the with_cuda_rhs step launched K5 b {k5_launches} times, expected "
                     f"{iters + 2}")
            say(f"[z4mf time] Z4+GRHD 2-D p2 fused {grid}: one eager step of the with_cuda_rhs "
                f"route (K5 b, {k5_launches} launches) {eager_ms!r} ms against CudaADERDG's "
                f"{statistics.median(win)!r} ms; max |difference| {max_err(torch, eager, ref)!r} "
                f"(f32 bound {f32_bound(torch, ref)!r}) ({card})")
            k5_ms = event_ms(torch, lambda: k5(*pic), 20)
            k5_plain_ms = event_ms(torch, lambda: sol.rhs_all_fn(*pic), 2)
            q_slots, grad_slots = z4_slots_read(torch, sol.rhs_all_fn)
            Q = pic[0]
            points = Q.numel() // Q.shape[pic[2]]
            # The 2-D algebra reads two of the three gradient directions.
            k5_bytes = Q.element_size() * points * (q_slots + 2 * grad_slots // 3
                                                    + Q.shape[pic[2]])
            k5_ops = z4_value_ops(torch, sol.rhs_all_fn, (0, 1)) * points
            b_k5 = bound(k5_bytes, k5_ops)
            say(f"[bound] {k5.kernel} a Picard call {tuple(Q.shape)} f32: {k5_bytes} B "
                f"({q_slots} state slots and two directions' {2 * grad_slots // 3} gradient "
                f"slots read, {Q.shape[pic[2]]} written), {k5_ops} operations (z4_value_ops "
                f"with two gradient axes, the recovery's Newton trips included): bound "
                f"{b_k5['bound_ms']!r} ms by {b_k5['bound_by']}; kernel {k5_ms!r} ms "
                f"({k5_ms / b_k5['bound_ms']:.2f}x), plain {k5_plain_ms!r} ms (CUDA events; "
                f"{card})")
            k5_line = kernel_line(f"{k5.kernel} (Z4+GRHD, K5 b)",
                                  "exahype_tpu/models/rhs_pallas.py:104", k5_launches, k5_err,
                                  k5_ms, k5_plain_ms, b_k5, "exahype_tpu_torch/csrc/rhs.cu")
            del kern, k5, eager, ref, pic, Q
        # Bounds: the algebra's operations (on the fused solver's hook, the
        # same algebra) and the cell's counts.
        if dim not in counts:
            hook = make((dim, "soa"), (1,) * dim, torch.float64, dx).rhs_all_fn
            axes = tuple(range(dim))
            counts[dim] = (z4_value_ops(torch, hook, axes), z4_value_ops(torch, hook, ()),
                           sum(z4_value_ops(torch, hook, (k,)) for k in axes) / dim,
                           sum(z4_ncp_ops(torch, hook, k) for k in axes),
                           z4_slots_read(torch, hook)[1] // 3)
            say(f"[bound] Z4+GRHD {dim}-D: the algebra's operations at a point (z4_value_ops, "
                f"the recovery included): every axis {counts[dim][0]}, none {counts[dim][1]}, "
                f"one {counts[dim][2]!r}; the {dim} NCP products together (z4_ncp_ops) "
                f"{counts[dim][3]}; gradient slots read an axis {counts[dim][4]}")
        full, zero, one_axis, ncp, gs = counts[dim]
        flux_ops = 1 + dim * (Z4M_FLUX_OPS - 1) // 3  # √γ p, then each axis's rows
        w = z4_kernel_work(Z4_ORDER, sol.picard_iters, math.prod(grid), 4, full, zero,
                           one_axis, v=sol.n_vars, gs=gs, hydro=5, flux_ops=flux_ops, dim=dim,
                           ncp=None if fused else ncp, names=cu.kernels)
        for name in cu.kernels:
            if name in ms and name not in work:
                work[name] = w[name]
                info[name] = (cu, f"{label(form)} {grid} f32")
        del sol, cu, un, u0, u, new, faces, fhat, fhalf
        torch.cuda.empty_cache()
    phase("the float32 forms at full width")

    # ------------------------------------------- examples/flrw_cosmology.py
    a_ref, adot_ref = flrw_reference(Z4MX_T, rho0=Z4M_RHO0, eps0=Z4M_EPS0, gamma=5.0 / 3.0)
    dt = Z4MX_T / Z4MX_STEPS
    for grid in Z4MX_GRIDS:
        for dtype in (torch.float64, torch.float32):
            sol = make((2, False), grid, dtype, Z4MX_DX, dict(Z4M_PARAMS, gamma=5.0 / 3.0))
            cu = CudaADERDG(sol)
            adot = math.sqrt(8.0 * math.pi * Z4M_RHO0 * (1.0 + Z4M_EPS0) / 3.0)
            u0 = flrw_state(sol, 1.0, adot, rho0=Z4M_RHO0, eps0=Z4M_EPS0)
            cu.reset_launches()
            u = cu.run(u0, Z4MX_STEPS, dt)
            torch.cuda.synchronize()
            got = dict(cu.launches)
            if got != {name: Z4MX_STEPS for name in cu.kernels}:
                fail(f"the example's run launched {got} in {Z4MX_STEPS} steps, expected 3 a step")
            if dtype == torch.float32:
                for name, n in got.items():
                    launches[name] = launches.get(name, 0) + n
            q = torch.movedim(u, sol.var_axis, -1).double()
            gxx, Dt = q[..., 1], q[..., 38]
            read = {
                "a2": (gxx - a_ref**2).abs().max().item() / a_ref**2,
                "Dt": (Dt - Z4M_RHO0).abs().max().item() / Z4M_RHO0,
                "theta": q[..., 13].abs().max().item(),
                "Z": q[..., 14:17].abs().max().item(),
            }
            kxx = (q[..., 7] + a_ref * adot_ref).abs().max().item() / abs(a_ref * adot_ref)
            ok = all(read[k] < Z4MX_BARS[k] for k in read) and bool(torch.isfinite(u).all())
            gated = dtype == torch.float64
            verdict = ("ok" if ok else "FAIL") if gated else (
                "a reading (gated in float64)" + (", within the bars" if ok else ", over them"))
            say(f"[z4mf example] examples/flrw_cosmology.py, 2-D p2 per-axis, {grid} at dx = "
                f"{Z4MX_DX} {str(dtype)[6:]}, {Z4MX_STEPS} steps to t = {Z4MX_T} through "
                f"CudaADERDG ({got}): largest relative a² error {read['a2']!r} (bar "
                f"{Z4MX_BARS['a2']}), K_xx {kxx!r}, D̃ drift {read['Dt']!r} (bar "
                f"{Z4MX_BARS['Dt']}), |Θ| {read['theta']!r}, |Z| {read['Z']!r} (bars "
                f"{Z4MX_BARS['theta']}) {verdict} ({card})")
            if not gated:  # the float32 run is a reading; the plain path is checked in float64
                del sol, cu, u0, u, q
                continue
            if not ok:
                fail(f"the example's bars fail on the kernels ({grid}, {dtype})")
            a = cu.run(u0, Z4X_PLAIN_STEPS, dt)
            b = sol.run(u0, Z4X_PLAIN_STEPS, dt)
            limit = Z4_F64_RTOL * max(1.0, b.abs().max().item())
            say(f"[z4mf example] {grid} {str(dtype)[6:]}, {Z4X_PLAIN_STEPS} step, kernel path vs "
                f"plain path: max_abs_err {max_err(torch, a, b):.3e} limit {limit:.3e}")
            if not max_err(torch, a, b) <= limit:
                fail(f"the example's kernel path disagrees with the plain path ({grid})")
            del sol, cu, u0, u, q, a, b
    phase("the example")

    # ------------------------------------------- reports and the JSON lines
    lines = []
    for name, (n_bytes, n_ops) in work.items():
        cu, where = info[name]
        bnd = kernel_report(cu, name, torch.float32, where, ms[name], n_bytes, n_ops, card)
        lines.append(kernel_line(f"{name} (Z4+GRHD, K1 d)",
                                 "exahype_tpu/models/aderdg_pallas.py:156", launches[name],
                                 errs[name], ms[name], plain_ms[name], bnd,
                                 "exahype_tpu_torch/csrc/aderdg_z4.cuh"))
    missing = [name for name in work if not launches.get(name)]
    if missing:
        fail(f"kernels of the Z4+GRHD per-axis and 2-D path never launched: {missing}")
    return lines + [k5_line]


def z4g_forms_path(torch, dev, card) -> list[dict]:
    """The Z4+GRMHD step as the JAX package builds it by default (the
    per-axis NCP, ``fused_rhs=False``) in 3-D and 2-D, and its fused 2-D
    step, through ``CudaADERDG``: K1 d's per-axis predictor with the matter
    flux on the 3-D cell (``csrc/aderdg_z4_grmhd_per_axis.cu``, with the
    fused Z4+GRMHD step's face pair) and the 2-D step at order 2, fused and
    per-axis (``csrc/aderdg_z4_grmhd_2d.cu``); K5 b's Z4+GRMHD instance
    (``rhs_all_z4_grmhd_2d``) under the 2-D fused solver's ``with_cuda_rhs``
    route.  Returns their lines of the kernel JSON."""
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4_grmhd import (
        magnetized_wave_state,
        make_z4_grmhd_solver,
        z4_grmhd_admissible,
    )
    from exahype_tpu_torch.models.z4_matter import make_z4_matter_solver

    def make(form, grid, dtype, dx, params=Z4G_PARAMS):
        dim, fused = form
        return make_z4_grmhd_solver(dim, Z4_ORDER, grid, dx=dx, fused_rhs=fused, device=dev,
                                    dtype=dtype, **params)

    def label(form):
        dim, fused = form
        return f"Z4+GRMHD {dim}-D p2 {'fused' if fused else 'per-axis'}"

    def cut(form):
        return (Z4F_CUT, Z4F_CUT_DX) if form[0] == 2 else (Z4_CUT, Z4_DX)

    admissible = z4_grmhd_admissible(gamma=Z4G_PARAMS["gamma"], iters=Z4G_PARAMS["iters"])
    t0 = time.perf_counter()

    def phase(what):
        say(f"[z4gf] {what}: {time.perf_counter() - t0:.1f} s into the path (host clock)")

    # ------------------------------------------- kernels vs plain, float64, cut grids
    k5_err = 0.0
    for params in Z4G_FAMILIES:  # the path's own parameters: float32 at full width below
        for form in Z4GF_FORMS:
            grid, dx = cut(form)
            sol64 = make(form, grid, torch.float64, dx, params)
            u = z4g_noisy(torch, sol64)
            if not bool(admissible(u, sol64.var_axis).all()):
                fail(f"the {label(form)} parity state is not admissible")
            z4_kernel_parity(torch, sol64, CudaADERDG(sol64), u, Z4_DT, f"{label(form)} {params}",
                             tag="z4gf")
            if form == (2, "soa"):  # K5 b on every call of a step
                k5 = with_cuda_rhs(sol64).rhs_all_fn
                for i, (Q, grads, va) in enumerate(z4_rhs_calls(sol64, u, Z4_DT)):
                    got, again = k5(Q, grads, va), k5(Q, grads, va)
                    ref = sol64.rhs_all_fn(Q, grads, va)
                    torch.cuda.synchronize()
                    err = max_err(torch, got, ref)
                    limit = Z4_F64_RTOL * max(1.0, ref.abs().max().item())
                    ok = err <= limit and torch.equal(got, again)
                    say(f"[z4gf parity] {k5.kernel} float64 {grid} {params} "
                        f"{z4_call_name(i, sol64.picard_iters)} {tuple(Q.shape)}: max_abs_err "
                        f"{err:.3e} limit {limit:.3e}; repeat bitwise {torch.equal(got, again)} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"K5 b's Z4+GRMHD instance disagrees with its plain version "
                             f"(float64, {z4_call_name(i, sol64.picard_iters)})")
                del k5, got, again, ref
            del sol64, u
    torch.cuda.empty_cache()
    phase("the float64 parity")

    # ------------------------------------------- the zero-field cross-check, float64
    # B̃ = φ̃ = 0 on a Z4+GRHD state: the first 43 rows of one kernel step of
    # each form are the Z4+GRHD kernels' step of the same form, to the
    # recoveries' convergence (the float32 recovery is NaN at a zero field in
    # both packages, ROADMAP.md Queue 3, so this runs in float64 only).
    rtol, atol = Z4G_ZERO_FIELD_TOL
    for form in Z4GF_FORMS:
        dim, fused = form
        grid, dx = cut(form)
        g64 = make(form, grid, torch.float64, dx, dict(Z4G_PARAMS, c_h=Z4G_ZERO_FIELD_CH))
        m64 = make_z4_matter_solver(dim, Z4_ORDER, grid, dx=dx, fused_rhs=fused, device=dev,
                                    dtype=torch.float64, **Z4M_PARAMS)
        va = m64.var_axis
        um = z4m_noisy(torch, m64)
        ug = torch.cat([um, torch.zeros_like(um.narrow(va, 0, 4))], dim=va).contiguous()
        cug, cum = CudaADERDG(g64), CudaADERDG(m64)
        sg, sm = cug.step(ug, Z4_DT), cum.step(um, Z4_DT)
        torch.cuda.synchronize()
        head = sg.narrow(va, 0, 43)
        err = max_err(torch, head, sm)
        excess = ((head - sm).abs() - rtol * sm.abs()).max().item()
        field = sg.narrow(va, 43, 4).abs().max().item()
        ok = excess <= atol and field == 0.0
        say(f"[z4gf zero field] {label(form)} float64 {grid}, B̃ = φ̃ = 0 on the Z4+GRHD parity "
            f"state, c_h = {Z4G_ZERO_FIELD_CH}: one step through CudaADERDG(Z4+GRMHD) vs "
            f"CudaADERDG(Z4+GRHD), rows 0-42: max_abs_err {err:.3e}, max(|a − b| − {rtol:g}|b|) "
            f"{excess:.3e} (limit {atol:g}); max|B̃, φ̃| after the step {field!r}; launches "
            f"{cug.launches} and {cum.launches} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"with B̃ = φ̃ = 0 the {label(form)} kernel step is not the Z4+GRHD one")
        del g64, m64, um, ug, cug, cum, sg, sm, head
    phase("the zero-field cross-check")

    # ------------------------------------------- float32 at full width: parity,
    # the main path (3 launches a step, repeatable, gated), times
    launches, errs, plain_ms, ms, work, info, counts = {}, {}, {}, {}, {}, {}, {}
    for form in Z4GF_FORMS:
        dim, fused = form
        grid, dx = (Z4F_GRID, 1.0 / Z4F_GRID[0]) if dim == 2 else (Z4_GRID, Z4_DX)
        sol = make(form, grid, torch.float32, dx)
        cu = CudaADERDG(sol)
        sol64 = make(form, grid, torch.float64, dx)
        un = z4g_noisy(torch, sol)
        times = {}
        for name, err in z4_kernel_parity(torch, sol, cu, un, Z4_DT, f"{label(form)}, full width",
                                          sol64, tag="z4gf", plain_ms=times).items():
            errs[name] = max(errs.get(name, 0.0), err)
        for name, t in times.items():
            plain_ms.setdefault(name, t)
        del sol64
        va = sol.var_axis
        u0 = magnetized_wave_state(sol, B0=Z4G_B0, amp=Z4G_AMP).contiguous()
        cfl = float(sol.cfl_dt(u0))
        if Z4_DT > cfl:
            fail(f"dt = {Z4_DT} is over the {label(form)} state's CFL limit {cfl}")
        if not bool(admissible(u0, va).all()):
            fail(f"the magnetized wave is not admissible ({label(form)})")
        totals0, field0 = z4g_totals(torch, sol, u0)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        cu.reset_launches()
        u = cu.run(u0, Z4F_STEPS, Z4_DT)
        torch.cuda.synchronize()
        got = dict(cu.launches)
        say(f"[z4gf main] {label(form)} {grid} f32 ({sol.dofs()} DOF), the magnetized wave (B0 = "
            f"{Z4G_B0}, amplitude {Z4G_AMP}, one period along axis 0), dt = {Z4_DT} (cfl_dt "
            f"{cfl!r}): {Z4F_STEPS} steps through CudaADERDG: launches {got} (expected "
            f"{Z4F_STEPS} of each: 3 a step) ({card})")
        if got != {name: Z4F_STEPS for name in cu.kernels}:
            fail(f"the {label(form)} step launched {got} in {Z4F_STEPS} steps, expected 3 a step")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
            fail(f"the {label(form)} state is not finite or has the wrong shape")
        if not bool(admissible(u, va).all()):
            fail(f"the {label(form)} state is not admissible")
        totals1, _ = z4g_totals(torch, sol, u)
        drifts = [abs(totals1[0] - totals0[0]) / abs(totals0[0])]
        drifts += [abs(b - a) / field0 for a, b in zip(totals0[1:], totals1[1:])]
        say(f"[z4gf main] {label(form)} over {Z4F_STEPS} steps: ∫D̃ dV {totals0[0]!r} -> "
            f"{totals1[0]!r}, drift {drifts[0]!r}; ∫B̃^i dV {totals0[1:]!r} -> {totals1[1:]!r}, "
            f"drift against ∫|B̃| dV = {field0!r}: {drifts[1:]!r} (gate {Z4G_DRIFT}); admissible "
            "(z4_grmhd_admissible) at every node")
        if not max(drifts) <= Z4G_DRIFT:
            fail(f"∫D̃ or ∫B̃^i dV drifted by {drifts} over {Z4F_STEPS} {label(form)} steps")
        if not torch.equal(u, cu.run(u0, Z4F_STEPS, Z4_DT)):
            fail(f"two {label(form)} runs from the same state differ")
        win = [1e3 * w for w in windows(torch, cu, u0, Z4_DT, steps=Z4F_STEPS)]
        say(f"[z4gf time] {label(form)} {grid} f32 step: ms per window {win!r}; median "
            f"{statistics.median(win)!r} ms, {sol.dofs() / statistics.median(win) * 1e3!r} "
            f"DOF-updates/s; runs bitwise equal ({card})")
        new, faces, _ = cu.predictor_volume(u0, Z4_DT)
        fhat, fhalf = cu.face_flux(faces)
        pred, flux, update = cu.kernels
        ms[pred] = event_ms(torch, lambda: cu.predictor_volume(u0, Z4_DT), 10)
        if dim == 2 and flux not in ms:  # the 2-D pair once (the 3-D pair is the Z4+GRMHD path's)
            ms[flux] = event_ms(torch, lambda: cu.face_flux(faces), 20)
            ms[update] = event_ms(
                torch, lambda: cu.surface_update(new, fhat, Z4_DT, fhalf=fhalf), 20)
        say(f"[z4gf time] {label(form)} kernels (CUDA events): " + ", ".join(
            f"{name} {ms[name]!r} ms (plain {plain_ms[name]!r} ms)" for name in cu.kernels
            if name in ms) + f" ({card})")
        if dim == 3:  # the fused step on the same state
            fcu = CudaADERDG(make((3, "soa"), grid, torch.float32, dx))
            fwin = [1e3 * w for w in windows(torch, fcu, u0, Z4_DT, steps=Z4F_STEPS)]
            fpred = event_ms(torch, lambda: fcu.predictor_volume(u0, Z4_DT), 10)
            say(f"[z4gf time] Z4+GRMHD 3-D p2 on the same state: per-axis step median "
                f"{statistics.median(win)!r} ms, predictor {ms[pred]!r} ms; fused step "
                f"{statistics.median(fwin)!r} ms (windows {fwin!r}), predictor {fpred!r} ms "
                f"({ms[pred] / fpred:.3f}x) ({card})")
            del fcu
        if form == (2, "soa"):  # K5 b's with_cuda_rhs route on the same state
            kern = with_cuda_rhs(sol)
            k5 = kern.rhs_all_fn
            iters = sol.picard_iters
            calls = z4_rhs_calls(sol, un, Z4_DT)
            for i in (0, iters):  # the Picard shape, the corrector's
                Q, grads, va_ = calls[i]
                got_k, ref = k5(Q, grads, va_), sol.rhs_all_fn(Q, grads, va_)
                ref64 = sol.rhs_all_fn(Q.double(), tuple(g.double() for g in grads), va_)
                torch.cuda.synchronize()
                err, limit = max_err(torch, got_k, ref), f32_bound(torch, ref)
                say(f"[z4gf parity] {k5.kernel} float32 {grid} {z4_call_name(i, iters)} "
                    f"{tuple(Q.shape)}: max_abs_err {err:.3e} limit {limit:.3e} ({F32_ULPS} f32 "
                    f"spacings of max|plain| = {ref.abs().max().item():.4g}) "
                    f"{'ok' if err <= limit else 'FAIL'}; against the float64 plain result: "
                    f"kernel {max_err(torch, got_k, ref64):.3e}, plain float32 "
                    f"{max_err(torch, ref, ref64):.3e}")
                if not err <= limit:
                    fail(f"K5 b's Z4+GRMHD instance (float32, {z4_call_name(i, iters)}) "
                         "disagrees with its plain version")
                k5_err = max(k5_err, err)
                del got_k, ref, ref64
            pic = calls[0]
            del calls
            k5.reset_launches()
            eager, eager_ms = timed_once(torch, lambda: kern.step(u0, Z4_DT))
            k5_launches = k5.launches
            ref = cu.step(u0, Z4_DT)
            if k5_launches != iters + 2:
                fail(f"the with_cuda_rhs step launched K5 b {k5_launches} times, expected "
                     f"{iters + 2}")
            say(f"[z4gf time] Z4+GRMHD 2-D p2 fused {grid}: one eager step of the with_cuda_rhs "
                f"route (K5 b, {k5_launches} launches) {eager_ms!r} ms against CudaADERDG's "
                f"{statistics.median(win)!r} ms; max |difference| {max_err(torch, eager, ref)!r} "
                f"(f32 bound {f32_bound(torch, ref)!r}) ({card})")
            k5_ms = event_ms(torch, lambda: k5(*pic), 20)
            k5_plain_ms = event_ms(torch, lambda: sol.rhs_all_fn(*pic), 2)
            q_slots, grad_slots = z4_slots_read(torch, sol.rhs_all_fn)
            Q = pic[0]
            points = Q.numel() // Q.shape[pic[2]]
            # The 2-D algebra reads two of the three gradient directions.
            k5_bytes = Q.element_size() * points * (q_slots + 2 * grad_slots // 3
                                                    + Q.shape[pic[2]])
            k5_ops = z4_value_ops(torch, sol.rhs_all_fn, (0, 1)) * points
            b_k5 = bound(k5_bytes, k5_ops)
            say(f"[bound] {k5.kernel} a Picard call {tuple(Q.shape)} f32: {k5_bytes} B "
                f"({q_slots} state slots and two directions' {2 * grad_slots // 3} gradient "
                f"slots read, {Q.shape[pic[2]]} written), {k5_ops} operations (z4_value_ops "
                f"with two gradient axes, the recovery's Newton trips included): bound "
                f"{b_k5['bound_ms']!r} ms by {b_k5['bound_by']}; kernel {k5_ms!r} ms "
                f"({k5_ms / b_k5['bound_ms']:.2f}x), plain {k5_plain_ms!r} ms (CUDA events; "
                f"{card})")
            k5_line = kernel_line(f"{k5.kernel} (Z4+GRMHD, K5 b)",
                                  "exahype_tpu/models/rhs_pallas.py:104", k5_launches, k5_err,
                                  k5_ms, k5_plain_ms, b_k5, "exahype_tpu_torch/csrc/rhs.cu")
            del kern, k5, eager, ref, pic, Q
        # Bounds: the algebra's operations (on the fused solver's hook, the
        # same algebra) and the cell's counts.
        if dim not in counts:
            hook = make((dim, "soa"), (1,) * dim, torch.float64, dx).rhs_all_fn
            axes = tuple(range(dim))
            counts[dim] = (z4_value_ops(torch, hook, axes), z4_value_ops(torch, hook, ()),
                           sum(z4_value_ops(torch, hook, (k,)) for k in axes) / dim,
                           sum(z4_ncp_ops(torch, hook, k) for k in axes),
                           z4_slots_read(torch, hook)[1] // 3)
            say(f"[bound] Z4+GRMHD {dim}-D: the algebra's operations at a point (z4_value_ops, "
                f"the recovery included): every axis {counts[dim][0]}, none {counts[dim][1]}, "
                f"one {counts[dim][2]!r}; the {dim} NCP products together (z4_ncp_ops) "
                f"{counts[dim][3]}; gradient slots read an axis {counts[dim][4]}")
        full, zero, one_axis, ncp, gs = counts[dim]
        w = z4_kernel_work(Z4_ORDER, sol.picard_iters, math.prod(grid), 4, full, zero,
                           one_axis, v=sol.n_vars, gs=gs, eig_ops=Z4G_EIG_OPS, hydro=9,
                           flux_ops=dim * Z4G_FLUX_OPS // 3, dim=dim,
                           ncp=None if fused else ncp, names=cu.kernels)
        for name in cu.kernels:
            if name in ms and name not in work:
                work[name] = w[name]
                info[name] = (cu, f"{label(form)} {grid} f32")
        del sol, cu, un, u0, u, new, faces, fhat, fhalf
        torch.cuda.empty_cache()
    phase("the float32 forms at full width")

    # ------------------------------------------- reports and the JSON lines
    lines = []
    for name, (n_bytes, n_ops) in work.items():
        cu, where = info[name]
        bnd = kernel_report(cu, name, torch.float32, where, ms[name], n_bytes, n_ops, card)
        lines.append(kernel_line(f"{name} (Z4+GRMHD, K1 d)",
                                 "exahype_tpu/models/aderdg_pallas.py:156", launches[name],
                                 errs[name], ms[name], plain_ms[name], bnd,
                                 "exahype_tpu_torch/csrc/aderdg_z4.cuh"))
    missing = [name for name in work if not launches.get(name)]
    if missing:
        fail(f"kernels of the Z4+GRMHD per-axis and 2-D path never launched: {missing}")
    return lines + [k5_line]


def z4s_forms_path(torch, dev, card) -> list[dict]:
    """The shifted Z4 step as the JAX package builds it by default (the
    per-axis NCP, ``fused_rhs=False``) in 3-D and 2-D, and its fused 2-D
    step, through ``CudaADERDG``: K1 d's per-axis predictor over the shifted
    system on the 3-D cell (``csrc/aderdg_z4_shift_per_axis.cu``, with the
    fused shifted step's face pair) and the 2-D step at order 2, fused and
    per-axis (``csrc/aderdg_z4_shift_2d.cu``); K5 b's shifted instance
    (``rhs_all_z4_shift_2d``) under the 2-D fused solver's ``with_cuda_rhs``
    route; the JAX package's shifted anchors through the 2-D per-axis
    kernels.  Returns their lines of the kernel JSON."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import (
        flat_state_values,
        make_z4_shift_solver,
        moving_gauge_wave_state,
    )

    f64 = torch.float64

    def make(form, grid, dtype, dx, params=Z4S_PARAMS):
        dim, fused = form
        return make_z4_shift_solver(dim, Z4_ORDER, grid, dx=dx, fused_rhs=fused, device=dev,
                                    dtype=dtype, **params)

    def label(form):
        dim, fused = form
        return f"shifted {dim}-D p2 {'fused' if fused else 'per-axis'}"

    def cut(form):
        return (Z4F_CUT, Z4F_CUT_DX) if form[0] == 2 else (Z4_CUT, Z4_DX)

    def noisy(sol, seed=5):
        u = moving_gauge_wave_state(sol, v=Z4S_V, amplitude=Z4_AMPLITUDE)
        noise = torch.from_numpy(np.random.default_rng(seed).standard_normal(tuple(u.shape)))
        return (u + Z4S_NOISE * noise.to(u)).contiguous()

    t0 = time.perf_counter()

    def phase(what):
        say(f"[z4sf] {what}: {time.perf_counter() - t0:.1f} s into the path (host clock)")

    # ------------------------------------------- kernels vs plain, float64, cut grids
    k5_err = 0.0
    for params in Z4S_FAMILIES:  # the path's own parameters: float32 at full width below
        for form in Z4SF_FORMS:
            grid, dx = cut(form)
            sol64 = make(form, grid, f64, dx, params)
            u = noisy(sol64)
            z4_kernel_parity(torch, sol64, CudaADERDG(sol64), u, Z4_DT, f"{label(form)} {params}",
                             tag="z4sf")
            if form == (2, "soa"):  # K5 b on every call of a step
                k5 = with_cuda_rhs(sol64).rhs_all_fn
                for i, (Q, grads, va) in enumerate(z4_rhs_calls(sol64, u, Z4_DT)):
                    got, again = k5(Q, grads, va), k5(Q, grads, va)
                    ref = sol64.rhs_all_fn(Q, grads, va)
                    torch.cuda.synchronize()
                    err = max_err(torch, got, ref)
                    limit = Z4_F64_RTOL * max(1.0, ref.abs().max().item())
                    ok = err <= limit and torch.equal(got, again)
                    say(f"[z4sf parity] {k5.kernel} float64 {grid} {params} "
                        f"{z4_call_name(i, sol64.picard_iters)} {tuple(Q.shape)}: max_abs_err "
                        f"{err:.3e} limit {limit:.3e}; repeat bitwise {torch.equal(got, again)} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"K5 b's shifted instance disagrees with its plain version "
                             f"(float64, {params}, {z4_call_name(i, sol64.picard_iters)})")
                del k5, got, again, ref
            del sol64, u
    torch.cuda.empty_cache()
    phase("the float64 parity")

    # ------------------------------------------- the JAX package's anchors, float64,
    # through the 2-D per-axis kernels (3 launches a step each)
    def per_axis_2d(grid, dx, **params):
        sol = make_z4_shift_solver(2, Z4_ORDER, grid, dx=dx, fused_rhs=False, device=dev,
                                   dtype=f64, **params)
        return sol, CudaADERDG(sol)

    def constant(sol, values):
        va = sol.var_axis
        shape = sol.state_shape[:va] + sol.state_shape[va + 1:]
        arr = np.moveaxis(np.broadcast_to(values, shape + (sol.n_vars,)), -1, va)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev, f64)

    def run_counted(cu, q0, n, dt):
        cu.reset_launches()
        out = cu.run(q0, n, dt)
        torch.cuda.synchronize()
        if cu.launches != {name: n for name in cu.kernels}:
            fail(f"an anchor run launched {cu.launches} in {n} steps, expected 3 a step")
        return out

    flat = np.concatenate([flat_state_values(), Z4SX_BETA, np.zeros(12)])
    for mode in ("frozen", "gamma_driver"):
        sol, cu = per_axis_2d((4, 2), 0.25, shift=mode)
        q0 = constant(sol, flat)
        err = max_err(torch, run_counted(cu, q0, 10, 5e-3), q0)
        ok = err <= Z4SX_STATIONARY
        say(f"[z4sf anchor] Minkowski with the constant shift β = {Z4SX_BETA}, {mode}, (4, 2) "
            f"at dx = 0.25, 10 steps of 5e-3 through {cu.kernels[0]} float64: max |Q − Q0| "
            f"{err!r} (gate {Z4SX_STATIONARY}; tests/test_z4.py:802) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"shifted flat space is not stationary on the kernels ({mode})")
    errors = []
    for cells in (4, 8):
        sol, cu = per_axis_2d((cells, 2), 1.0 / cells, shift="frozen")
        n = 4 * cells
        q = run_counted(cu, moving_gauge_wave_state(sol, t=0.0, v=Z4S_V), n, 0.08 / n)
        exact = moving_gauge_wave_state(sol, t=0.08, v=Z4S_V)
        err2 = ((q - exact) ** 2 * node_weights(torch, sol, q)).sum().item()
        errors.append(math.sqrt(err2 * math.prod(sol._dxs)))
    rate = math.log2(errors[0] / errors[1])
    say(f"[z4sf anchor] the frozen moving gauge wave (v = {Z4S_V}, amplitude 0.01) to t = 0.08 "
        f"on (4, 2) and (8, 2) cells through the 2-D per-axis kernels, float64: L2 errors "
        f"{errors!r}, rate {rate!r} (gate > {Z4SX_RATE}; tests/test_z4.py:829) "
        f"{'ok' if rate > Z4SX_RATE else 'FAIL'}")
    if not rate > Z4SX_RATE:
        fail(f"the moving gauge wave converges at rate {rate} on the kernels")
    sol, cu = per_axis_2d((4, 4), 0.25, shift="gamma_driver", kappa1=0.5, eta=2.0)
    base = constant(sol, np.concatenate([flat_state_values(), np.zeros(15)]))
    noise = np.random.default_rng(1).standard_normal(sol.state_shape)
    q = run_counted(cu, base + 1e-6 * torch.from_numpy(noise).to(base), 40, 2e-3)
    drift = max_err(torch, q, base)
    ok = bool(torch.isfinite(q).all()) and drift < Z4SX_DRIVER
    say(f"[z4sf anchor] flat space with noise of 1e-6 under the Gamma-driver (κ₁ = 0.5, η = 2), "
        f"(4, 4) at dx = 0.25, 40 steps of 2e-3 through the 2-D per-axis kernels, float64: "
        f"max |Q − flat| {drift!r} (gate < {Z4SX_DRIVER}; tests/test_z4.py:849) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the Gamma-driver run on the kernels did not stay bounded")
    del sol, cu, q, q0, base, exact
    phase("the JAX package's anchors")

    # ------------------------------------------- float32 at full width: parity,
    # the main path (3 launches a step, repeatable, finite), times
    launches, errs, plain_ms, ms, work, info, counts = {}, {}, {}, {}, {}, {}, {}
    for form in Z4SF_FORMS:
        dim, fused = form
        grid, dx = (Z4F_GRID, 1.0 / Z4F_GRID[0]) if dim == 2 else (Z4_GRID, Z4_DX)
        sol = make(form, grid, torch.float32, dx)
        cu = CudaADERDG(sol)
        sol64 = make(form, grid, f64, dx)
        u0 = noisy(sol)
        times = {}
        for name, err in z4_kernel_parity(torch, sol, cu, u0, Z4_DT, f"{label(form)}, full width",
                                          sol64, tag="z4sf", plain_ms=times).items():
            errs[name] = max(errs.get(name, 0.0), err)
        for name, t in times.items():
            plain_ms.setdefault(name, t)
        del sol64
        va = sol.var_axis
        cfl = float(sol.cfl_dt(u0))
        if Z4_DT > cfl:
            fail(f"dt = {Z4_DT} is over the {label(form)} state's CFL limit {cfl}")
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        cu.reset_launches()
        u = cu.run(u0, Z4F_STEPS, Z4_DT)
        torch.cuda.synchronize()
        got = dict(cu.launches)
        say(f"[z4sf main] {label(form)} {grid} f32 ({sol.dofs()} DOF), the moving gauge wave (v = "
            f"{Z4S_V}, amplitude {Z4_AMPLITUDE}) with noise of {Z4S_NOISE} on every slot, "
            f"{Z4S_PARAMS}, dt = {Z4_DT} (cfl_dt {cfl!r}): {Z4F_STEPS} steps through "
            f"CudaADERDG: launches {got} (expected {Z4F_STEPS} of each: 3 a step) ({card})")
        if got != {name: Z4F_STEPS for name in cu.kernels}:
            fail(f"the {label(form)} step launched {got} in {Z4F_STEPS} steps, expected 3 a step")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        if tuple(u.shape) != sol.state_shape or not torch.isfinite(u).all():
            fail(f"the {label(form)} state is not finite or has the wrong shape")
        beta = u.narrow(va, 38, 3) - torch.tensor(
            (Z4S_V, 0.0, 0.0), dtype=u.dtype, device=u.device).reshape(
                (3,) + (1,) * (u.dim() - va - 1))
        say(f"[z4sf reading] {label(form)} after {Z4F_STEPS} steps: max|β − (v, 0, 0)| "
            f"{beta.abs().max().item()!r}, max|b| {u.narrow(va, 41, 3).abs().max().item()!r}, "
            f"max|B| {u.narrow(va, 44, 9).abs().max().item()!r} (the Gamma-driver moves the "
            "gauge sector); finite")
        if not torch.equal(u, cu.run(u0, Z4F_STEPS, Z4_DT)):
            fail(f"two {label(form)} runs from the same state differ")
        win = [1e3 * w for w in windows(torch, cu, u0, Z4_DT, steps=Z4F_STEPS)]
        say(f"[z4sf time] {label(form)} {grid} f32 step: ms per window {win!r}; median "
            f"{statistics.median(win)!r} ms, {sol.dofs() / statistics.median(win) * 1e3!r} "
            f"DOF-updates/s; runs bitwise equal ({card})")
        new, faces, _ = cu.predictor_volume(u0, Z4_DT)
        fhat, fhalf = cu.face_flux(faces)
        pred, flux, update = cu.kernels
        ms[pred] = event_ms(torch, lambda: cu.predictor_volume(u0, Z4_DT), 10)
        if dim == 2 and flux not in ms:  # the 2-D pair once (the 3-D pair is the shifted path's)
            ms[flux] = event_ms(torch, lambda: cu.face_flux(faces), 20)
            ms[update] = event_ms(
                torch, lambda: cu.surface_update(new, fhat, Z4_DT, fhalf=fhalf), 20)
        say(f"[z4sf time] {label(form)} kernels (CUDA events): " + ", ".join(
            f"{name} {ms[name]!r} ms (plain {plain_ms[name]!r} ms)" for name in cu.kernels
            if name in ms) + f" ({card})")
        if dim == 3:  # the fused step on the same state
            fcu = CudaADERDG(make((3, "soa"), grid, torch.float32, dx))
            fwin = [1e3 * w for w in windows(torch, fcu, u0, Z4_DT, steps=Z4F_STEPS)]
            fpred = event_ms(torch, lambda: fcu.predictor_volume(u0, Z4_DT), 10)
            say(f"[z4sf time] shifted 3-D p2 on the same state: per-axis step median "
                f"{statistics.median(win)!r} ms, predictor {ms[pred]!r} ms; fused step "
                f"{statistics.median(fwin)!r} ms (windows {fwin!r}), predictor {fpred!r} ms "
                f"({ms[pred] / fpred:.3f}x) ({card})")
            del fcu
        if form == (2, "soa"):  # K5 b's with_cuda_rhs route on the same state
            kern = with_cuda_rhs(sol)
            k5 = kern.rhs_all_fn
            iters = sol.picard_iters
            calls = z4_rhs_calls(sol, u0, Z4_DT)
            for i in (0, iters):  # the Picard shape, the corrector's
                Q, grads, va_ = calls[i]
                got_k, ref = k5(Q, grads, va_), sol.rhs_all_fn(Q, grads, va_)
                ref64 = sol.rhs_all_fn(Q.double(), tuple(g.double() for g in grads), va_)
                torch.cuda.synchronize()
                err, limit = max_err(torch, got_k, ref), f32_bound(torch, ref)
                say(f"[z4sf parity] {k5.kernel} float32 {grid} {z4_call_name(i, iters)} "
                    f"{tuple(Q.shape)}: max_abs_err {err:.3e} limit {limit:.3e} ({F32_ULPS} f32 "
                    f"spacings of max|plain| = {ref.abs().max().item():.4g}) "
                    f"{'ok' if err <= limit else 'FAIL'}; against the float64 plain result: "
                    f"kernel {max_err(torch, got_k, ref64):.3e}, plain float32 "
                    f"{max_err(torch, ref, ref64):.3e}")
                if not err <= limit:
                    fail(f"K5 b's shifted instance (float32, {z4_call_name(i, iters)}) "
                         "disagrees with its plain version")
                k5_err = max(k5_err, err)
                del got_k, ref, ref64
            pic = calls[0]
            del calls
            k5.reset_launches()
            eager, eager_ms = timed_once(torch, lambda: kern.step(u0, Z4_DT))
            k5_launches = k5.launches
            ref = cu.step(u0, Z4_DT)
            if k5_launches != iters + 2:
                fail(f"the with_cuda_rhs step launched K5 b {k5_launches} times, expected "
                     f"{iters + 2}")
            say(f"[z4sf time] shifted 2-D p2 fused {grid}: one eager step of the with_cuda_rhs "
                f"route (K5 b, {k5_launches} launches) {eager_ms!r} ms against CudaADERDG's "
                f"{statistics.median(win)!r} ms; max |difference| {max_err(torch, eager, ref)!r} "
                f"(f32 bound {f32_bound(torch, ref)!r}) ({card})")
            k5_ms = event_ms(torch, lambda: k5(*pic), 20)
            k5_plain_ms = event_ms(torch, lambda: sol.rhs_all_fn(*pic), 2)
            q_slots, grad_slots = z4_slots_read(torch, sol.rhs_all_fn)
            Q = pic[0]
            points = Q.numel() // Q.shape[pic[2]]
            # The 2-D algebra reads two of the three gradient directions.
            k5_bytes = Q.element_size() * points * (q_slots + 2 * grad_slots // 3
                                                    + Q.shape[pic[2]])
            k5_ops = z4_value_ops(torch, sol.rhs_all_fn, (0, 1)) * points
            b_k5 = bound(k5_bytes, k5_ops)
            say(f"[bound] {k5.kernel} a Picard call {tuple(Q.shape)} f32: {k5_bytes} B "
                f"({q_slots} state slots and two directions' {2 * grad_slots // 3} gradient "
                f"slots read, {Q.shape[pic[2]]} written), {k5_ops} operations (z4_value_ops "
                f"with two gradient axes): bound {b_k5['bound_ms']!r} ms by "
                f"{b_k5['bound_by']}; kernel {k5_ms!r} ms ({k5_ms / b_k5['bound_ms']:.2f}x), "
                f"plain {k5_plain_ms!r} ms (CUDA events; {card})")
            k5_line = kernel_line(f"{k5.kernel} (shifted, K5 b)",
                                  "exahype_tpu/models/rhs_pallas.py:104", k5_launches, k5_err,
                                  k5_ms, k5_plain_ms, b_k5, "exahype_tpu_torch/csrc/rhs.cu")
            del kern, k5, eager, ref, pic, Q
        # Bounds: the algebra's operations (on the fused solver's hook, the
        # same algebra) and the cell's counts.
        if dim not in counts:
            hook = make((dim, "soa"), (1,) * dim, f64, dx).rhs_all_fn
            axes = tuple(range(dim))
            counts[dim] = (z4_value_ops(torch, hook, axes), z4_value_ops(torch, hook, ()),
                           sum(z4_value_ops(torch, hook, (k,)) for k in axes) / dim,
                           sum(z4_ncp_ops(torch, hook, k) for k in axes),
                           z4_slots_read(torch, hook)[1] // 3)
            say(f"[bound] shifted {dim}-D: the algebra's operations at a point (z4_value_ops): "
                f"every axis {counts[dim][0]}, none {counts[dim][1]}, one {counts[dim][2]!r}; "
                f"the {dim} NCP products together (z4_ncp_ops) {counts[dim][3]}; gradient "
                f"slots read an axis {counts[dim][4]}")
        full, zero, one_axis, ncp, gs = counts[dim]
        w = z4_kernel_work(Z4_ORDER, sol.picard_iters, math.prod(grid), 4, full, zero,
                           one_axis, v=sol.n_vars, gs=gs, eig_ops=25, dim=dim,
                           ncp=None if fused else ncp, names=cu.kernels)
        for name in cu.kernels:
            if name in ms and name not in work:
                work[name] = w[name]
                info[name] = (cu, f"{label(form)} {grid} f32")
        del sol, cu, u0, u, new, faces, fhat, fhalf
        torch.cuda.empty_cache()
    phase("the float32 forms at full width")

    # ------------------------------------------- reports and the JSON lines
    lines = []
    for name, (n_bytes, n_ops) in work.items():
        cu, where = info[name]
        bnd = kernel_report(cu, name, torch.float32, where, ms[name], n_bytes, n_ops, card)
        lines.append(kernel_line(f"{name} (shifted, K1 d)",
                                 "exahype_tpu/models/aderdg_pallas.py:156", launches[name],
                                 errs[name], ms[name], plain_ms[name], bnd,
                                 "exahype_tpu_torch/csrc/aderdg_z4.cuh"))
    missing = [name for name in work if not launches.get(name)]
    if missing:
        fail(f"kernels of the shifted per-axis and 2-D path never launched: {missing}")
    return lines + [k5_line]


def flowing_sod_state(solver, torch, device, dtype, ux=WALLS_UX):
    """:func:`sod_state` with a uniform flow ``ux`` along axis 0 added: the
    momentum ρ u_x and the kinetic energy ½ ρ u_x² (the pressures stay)."""
    q = sod_state(solver, torch, device, dtype)
    va = solver.var_axis
    rho = q.select(va, 0)
    q.select(va, 1).copy_(ux * rho)
    q.select(va, 4).add_(0.5 * ux * ux * rho)
    return q


def wall_rows(mask, g0: int) -> int:
    """Rows (last-axis lines of cells) with a troubled cell in the first or
    last cell plane of axis 0, where the walls are."""
    rows = mask.any(dim=-1)
    return int(rows[0].sum() + rows[g0 - 1].sum())


def limited_walls_path(torch, dev, card) -> list[dict]:
    """The limited step with reflective walls on axis 0 on the gathered row
    fallback (3-D); returns the kernel JSON lines of its walled face stage
    and its K3 sweeps."""
    import numpy as np

    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.models.aderdg import (
        ADERDGSolver,
        euler_physics,
        euler_reflect,
        euler_reflect_flux,
    )
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    flux, eig = euler_physics(3, n_real=5)
    adm = euler_admissible(3)
    box = dict(boundary="reflective", wall_axes=WALLS_AXES, reflect_fn=euler_reflect(3),
               reflect_flux_fn=euler_reflect_flux(3))

    def make(grid, dtype, walls):
        sol = ADERDGSolver(3, ORDER, 5, grid, flux, eig, dx=DX, device=dev, dtype=dtype, **walls)
        cu = CudaADERDG(sol)
        opts = dict(troubled_capacity=CAPACITY, troubled_granularity="row",
                    dmp_delta0=DMP_DELTA0, device=dev)
        kernel = LimitedADERDG(sol, adm, accelerator=cu, subcell_cuda=True, **opts)
        return sol, cu, kernel, LimitedADERDG(sol, adm, **opts)

    # ---------------------------------- 3. f64 on the cut grid
    # The candidate's face fluxes, which the limiter matches against, slot
    # for slot (the last row of a wall axis is the high-wall flux) in every
    # wall mode; then limited steps against the plain limiter.
    for name in ("reflective box", "outflow (0,)", "farfield (0,)", "dirichlet box",
                 "reflective (1, 2)"):
        sol = ADERDGSolver(3, ORDER, 5, WALL_CUT, flux, eig, dx=DX, device=dev,
                           dtype=torch.float64, **euler_walls(name, WALL_CUT))
        cu = CudaADERDG(sol)
        u = flowing_sod_state(sol, torch, dev, torch.float64)
        new_k, fl_k = cu.step(u, LIMITED_DT, return_face_fluxes=True)
        new_p, fl_p = sol.step(u, LIMITED_DT, return_face_fluxes=True)
        torch.cuda.synchronize()
        errs = [max_err(torch, new_k, new_p)] + [max_err(torch, a, b) for a, b in zip(fl_k, fl_p)]
        say(f"[limited walls parity] {name} f64 {WALL_CUT}: CudaADERDG.step(return_face_fluxes"
            f"=True) against the plain step: state {errs[0]:.3e}, face fluxes per axis "
            f"{[f'{e:.3e}' for e in errs[1:]]} (limit {F64_ATOL:.0e})")
        if not max(errs) <= F64_ATOL:
            fail(f"the walled candidate's face fluxes disagree with the plain step ({name})")
    for name in ("reflective (0,)", "outflow (0,)", "farfield (0,)"):
        walls = box if name == "reflective (0,)" else euler_walls(name, WALL_CUT)
        sol, cu, lim, plain = make(WALL_CUT, torch.float64, walls)
        a = b = flowing_sod_state(sol, torch, dev, torch.float64)
        for k in range(2):
            mask_k = lim.troubled_mask(a, cu.step(a, LIMITED_DT))
            mask_p = plain.troubled_mask(b, sol.step(b, LIMITED_DT))
            a, b = lim.step(a, LIMITED_DT), plain.step(b, LIMITED_DT)
            torch.cuda.synchronize()
            err = max_err(torch, a, b)
            say(f"[limited walls parity] {name} f64 {WALL_CUT}, step {k + 1}: troubled cells "
                f"{int(mask_k.sum())} (kernel candidate) / {int(mask_p.sum())} (plain), wall "
                f"rows {wall_rows(mask_k, WALL_CUT[0])}; limited step kernel path vs "
                f"plain path max_abs_err {err:.3e} (limit {F64_ATOL:.0e})")
            if not (torch.equal(mask_k, mask_p) and err <= F64_ATOL):
                fail(f"the walled limited step disagrees with the plain limiter ({name})")
    del sol, cu, lim, plain, u, a, b

    # ---------------------------------- 4. the main path at full width
    sol, cu, lim, plain = make(GRID, torch.float32, box)
    u0 = flowing_sod_state(sol, torch, dev, torch.float32)
    say(f"[limited walls] {GRID} f32, reflective walls on axes {WALLS_AXES}, the Sod state "
        f"with u_x = {WALLS_UX} added; dt = {LIMITED_DT!r}; cfl_dt(initial state) = "
        f"{float(sol.cfl_dt(u0))!r}; capacity {CAPACITY} rows; kernels {cu.kernels}")
    u5 = lim.run(u0, WARMUP, LIMITED_DT)
    torch.cuda.synchronize()
    if not torch.isfinite(u5).all():
        fail("the walled limited state is not finite after the warm-up")
    gib = 2.0**-30
    torch.cuda.reset_peak_memory_stats()
    cu.reset_launches()
    subcell_cuda.reset_launches()
    u = lim.run(u5, STEPS, LIMITED_DT)
    torch.cuda.synchronize()
    launches = {**cu.launches, **subcell_cuda.launches}
    say(f"[limited walls main] {STEPS} steps of {GRID} f32 after {WARMUP} warm-up steps: "
        f"launches {launches}; peak {torch.cuda.max_memory_allocated() * gib:.4f} GiB "
        f"allocated ({card})")
    want = {**{name: 0 for name in subcell_cuda.launches},
            **{name: STEPS for name in cu.kernels}, "subcell_row_sweep": 3 * STEPS}
    if launches != want:
        fail(f"the walled limited path launches {launches}, expected {want}")
    finite, admissible = bool(torch.isfinite(u).all()), bool(adm(u, sol.var_axis).all())
    say(f"[limited walls main] state finite {finite}, admissible {admissible}, rho_min "
        f"{u.select(sol.var_axis, 0).min().item()!r}")
    if tuple(u.shape) != sol.state_shape or not (finite and admissible):
        fail("the walled limited state is not finite and admissible")
    demand, at_walls, v = [], [], u5
    for _ in range(STEPS):
        mask = lim.troubled_mask(v, cu.step(v, LIMITED_DT))
        demand.append(int(mask.any(dim=-1).sum()))
        at_walls.append(wall_rows(mask, GRID[0]))
        v = lim.step(v, LIMITED_DT)
    overflow = max(demand) > CAPACITY
    say(f"[limited walls] troubled rows per checked step {demand} against capacity "
        f"{CAPACITY} (overflow engaged {overflow}); of them touching a wall {at_walls}")
    if not torch.equal(u, v):
        fail("two walled limited runs from the same state differ")
    say("[limited walls main] two runs from the same state: bitwise equal")
    if not min(at_walls) > 0:
        fail("a checked step of the walled limited path troubled no row at a wall")
    m0, m1 = sol.total_mass(u5.double()), sol.total_mass(u.double())
    rel = ((m1 - m0).abs() / m0.abs()).tolist()
    say(f"[limited walls main] relative drift over {STEPS} steps: mass {rel[0]:.3e}, energy "
        f"{rel[4]:.3e} (limit {MASS_RTOL:.1e}: the reflective box conserves both); momentum "
        f"along the walls' axis {(m1 - m0)[1].item()!r} (the walls push)")
    if not (rel[0] <= MASS_RTOL and rel[4] <= MASS_RTOL):
        fail("the walled limited step leaks mass or energy")
    mask_k = lim.troubled_mask(u, cu.step(u, LIMITED_DT))
    mask_p = plain.troubled_mask(u, sol.step(u, LIMITED_DT))
    step_k, step_p = lim.step(u, LIMITED_DT), plain.step(u, LIMITED_DT)
    torch.cuda.synchronize()
    err, limit = max_err(torch, step_k, step_p), f32_bound(torch, step_p)
    say(f"[limited walls main] one step, kernel path vs plain path: troubled cells "
        f"{int(mask_k.sum())} / {int(mask_p.sum())}, masks equal {torch.equal(mask_k, mask_p)}; "
        f"state max_abs_err {err:.3e} limit {limit:.3e}")
    if not (torch.equal(mask_k, mask_p) and err <= limit):
        fail("the walled limited kernel path disagrees with the plain path")
    real_sweep, seen = subcell_cuda.row_sweep_call, []

    def poisoned(limiter, d, s, lo, hi, dt, n_active):
        n = int(n_active)
        seen.append((n, s.shape[-2]))
        for x in (s, lo, hi):
            x[..., n:, :] = float("nan")
        s, g_lo, g_hi = real_sweep(limiter, d, s, lo, hi, dt, n_active)
        g_lo[:, n:] = float("nan")
        g_hi[:, n:] = float("nan")
        return s, g_lo, g_hi

    subcell_cuda.row_sweep_call = poisoned
    try:
        step_nan = lim.step(u, LIMITED_DT)
    finally:
        subcell_cuda.row_sweep_call = real_sweep
    torch.cuda.synchronize()
    same = torch.equal(step_nan, step_k)
    say(f"[limited walls main] poison: the inactive slots, their ghosts and edge fluxes NaN "
        f"((n_active, K) of each sweep: {seen}): bitwise equal to the ordinary step {same}")
    if not (same and len(seen) == 3 and seen[0][0] < seen[0][1]):
        fail("the poisoned walled limited step differs, or poisoned no slot")
    del mask_k, mask_p, step_k, step_p, step_nan, v

    # The walled face stage against plain on this path's state (f32).
    errs = walls_parity(torch, sol, cu, u5, LIMITED_DT, "limited walls, axis 0", 5, [(0, 5)])

    # ---------------------------------- K3 on this path's gathered batch
    candidate = cu.step(u5, LIMITED_DT)
    tables = plain._gather_tables_row(plain.troubled_mask(u5, candidate))
    n_active = int(tables["n_active"])
    recorded = record_sweeps(plain, u5, LIMITED_DT, tables)
    k3_err, k3_ms, k3_plain_ms = 0.0, {}, {}
    n_dev = tables["n_active"]
    for d, s, lo, hi in recorded:
        ref = plain._row_sweep_math(s, lo, hi, d, LIMITED_DT)
        k3_err = max(k3_err, k3_check(torch, subcell_cuda, lim, d, s, lo, hi, n_active, ref,
                                      f"{tuple(s.shape)} (walled gathered batch)"))
        work = s.clone()
        k3_ms[d] = device_ms(torch, lambda: subcell_cuda.row_sweep_call(
            lim, d, work, lo, hi, LIMITED_DT, n_dev), 20, "subcell_row_sweep")
        k3_plain_ms[d] = event_ms(torch, lambda: plain._row_sweep_math(
            s, lo, hi, d, LIMITED_DT), 3)
        del ref, work
    sweep_shape = tuple(recorded[0][1].shape)
    del recorded, candidate

    # ---------------------------------- times
    dofs = sol.dofs()
    for label, solver, steps, n in (("kernel path", lim, STEPS, 3), ("plain path", plain, 2, 1)):
        win = windows(torch, solver, u5, LIMITED_DT, steps=steps, n_windows=n)
        ms = [1e3 * w for w in win]
        say(f"[limited walls time] {label}: step ms per window {ms!r}; median "
            f"{statistics.median(ms)!r} ms, {dofs / statistics.median(win)!r} DOF-updates/s "
            f"({dofs} DOF per step; {card})")
    new, faces, _ = cu.predictor_volume(u5, LIMITED_DT)
    fhat, fwall = cu.face_flux(faces)
    walls = cu.wall_fluxes(fwall)
    times = {
        cu.kernels[0]: (event_ms(torch, lambda: cu.predictor_volume(u5, LIMITED_DT), 10),
                        event_ms(torch, lambda: sol.predictor_volume(u5, LIMITED_DT), 2)),
        cu.kernels[1]: (event_ms(torch, lambda: cu.face_flux(faces), 10),
                        event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 2)),
        cu.kernels[2]: (event_ms(torch, lambda: cu.surface_update(new, fhat, LIMITED_DT, fwall),
                                 10),
                        event_ms(torch, lambda: plain_surface_update(sol, new, fhat, LIMITED_DT,
                                                                     walls), 2)),
        "face stage": (event_ms(torch, lambda: cu.face_surface(new, faces, LIMITED_DT, True), 10),
                       event_ms(torch, lambda: sol.face_surface(new, faces, LIMITED_DT, True), 2)),
    }
    step_ms = event_ms(torch, lambda: lim.step(u5, LIMITED_DT), 10)
    in_step = device_ms(torch, lambda: lim.step(u5, LIMITED_DT), 3, "subcell_row_sweep", 3)
    say(f"[limited walls time] per call (CUDA events): " + ", ".join(
        f"{k} {v[0]!r} ms (plain {v[1]!r} ms)" for k, v in times.items()) + f"; sweeps "
        f"{list(k3_ms.values())!r} ms (device time, plain {list(k3_plain_ms.values())!r} ms); "
        f"whole step {step_ms!r} ms, of which the sweeps {in_step!r} ms and the three ADER-DG "
        f"launches {times[cu.kernels[0]][0] + times['face stage'][0]!r} ms ({card})")
    del new, faces, fhat, fwall, walls
    idle, busy, wall = idle_share(torch, lambda: lim.run(u5, STEPS, LIMITED_DT))
    say(f"[limited walls idle] kernel path, {STEPS} steps under torch.profiler: device busy "
        f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")

    # ---------------------------------- bounds
    itemsize = u5.element_size()
    ncell = math.prod(GRID)
    face_bytes = torch.empty(sol.face_shape, dtype=u5.dtype, device="meta").nbytes
    fhat_bytes = 3 * sol.n_nodes**2 * sol.n_vars * ncell * itemsize
    side = cu.walls["size"] * itemsize
    low = cu.walls["size"] // sol.n_vars
    work = {
        cu.kernels[0]: (2 * u5.nbytes + face_bytes,
                        predictor_ops(ORDER, sol.picard_iters, ncell)),
        cu.kernels[1]: (face_flux_bytes(ORDER, ncell, itemsize) + side,
                        face_flux_ops(ORDER, ncell) + low * (2 * EIG_OPS + 6 * 5)),
        cu.kernels[2]: (surface_update_bytes(ORDER, ncell, itemsize) + side,
                        surface_update_ops(ORDER, ncell)),
        "face stage": (face_fhat_bytes(face_bytes, u5.nbytes, fhat_bytes) + side,
                       face_surface_ops(ORDER, ncell) + low * (2 * EIG_OPS + 6 * 5)),
    }
    replaces = "exahype_tpu/models/aderdg_pallas.py:156"
    lines = []
    for name in (*cu.kernels, "face stage"):
        bnd = kernel_report(None if name == "face stage" else cu, name, torch.float32,
                            f"(limited walls path) {GRID} f32", times[name][0], *work[name],
                            card)
        if name == cu.kernels[0]:
            continue  # the ADER-DG path's line holds the predictor
        label = (f"{cu.kernels[1]} + {cu.kernels[2]} (face stage with face fluxes, limited "
                 "walls path)" if name == "face stage" else f"{name} (limited walls path)")
        count = launches[cu.kernels[2] if name == "face stage" else name]
        err = max(errs[cu.kernels[1]], errs[name]) if name == "face stage" else errs[name]
        lines.append(kernel_line(label, replaces, count, err, *times[name], bnd))
    k3_info = subcell_cuda.kernel_info(torch.float32)
    n_cells = sweep_shape[4] * sweep_shape[5]
    k3_bnd = kernel_report(None, "subcell_row_sweep", torch.float32,
                           f"(limited walls path, {n_active} active slots) {sweep_shape} f32, "
                           "mean of 3 directions", statistics.mean(k3_ms.values()),
                           sweep_bytes(49 * n_active * GRID[-1], n_cells, itemsize),
                           sweep_ops(49 * n_active * GRID[-1]), card, info=k3_info)
    lines.append({
        "name": "subcell_row_sweep (limited walls path)",
        "route": "cuda",
        "source": "exahype_tpu_torch/csrc/subcell.cu",
        "replaces": "exahype_tpu/models/subcell_pallas.py:47",
        "launches": launches["subcell_row_sweep"],
        "max_abs_err": k3_err,
        "ms": statistics.mean(k3_ms.values()),
        "plain_ms": statistics.mean(k3_plain_ms.values()),
        **k3_bnd,
        "library_ms": None,  # no single PyTorch call computes it
    })
    del sol, cu, lim, plain, u0, u5, u
    torch.cuda.empty_cache()
    return lines


def blast_state(torch, solver, dtype):
    """``examples/limited_blast_walls.py:56-63``: the pressurised disc r <
    0.1 at the box's centre (ρ 1, p 10 inside; ρ 0.125, p 0.1 outside), at
    rest."""
    import numpy as np

    x, y = solver.nodes_meshgrid()
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2
    inside = np.squeeze(r2 < 0.1**2, axis=solver.var_axis)
    rho = np.where(inside, 1.0, 0.125)
    p = np.where(inside, 10.0, 0.1)
    z = np.zeros_like(rho)
    q = np.stack([rho, z, z, p / 0.4], axis=solver.var_axis)
    return torch.from_numpy(np.ascontiguousarray(q)).to(solver.weights.device, dtype)


def parity_2d(torch, sol, cu, u, dt, label: str, tag: str, fv64=None,
              faces64=None) -> dict:
    """The 2-D kernels against their plain versions on ``u``
    (:func:`stages_2d`): float64 at ``F64_ATOL``, float32 within ``F32_ULPS``
    spacings of the largest plain value; a viscous solver's float32 wall
    planes against ``fv64``, the plain float64 planes
    (:func:`fvwall_f32_check`), or without ``fv64`` only printed (a state
    whose planes float32 cannot resolve); with ``faces64``, the plain
    float64 faces, the float32 predictor's faces against them within
    ``FVWALL_F32_FACTOR`` times the plain float32 faces' own distance (or
    ``F32_ULPS`` spacings of max|faces64|); ``[{tag} parity]`` lines.  Fails
    on a disagreement; returns the largest error of each kernel."""
    f64 = u.dtype == torch.float64
    errs = {}
    for name, what, got, ref in stages_2d(torch, sol, cu, u, dt):
        err = max_err(torch, got, ref)
        limit, why = (F64_ATOL if f64 else f32_bound(torch, ref)), ""
        if what == "faces" and not f64 and faces64 is not None:
            plain = max_err(torch, ref, faces64)
            err = max_err(torch, got, faces64)
            limit = max(FVWALL_F32_FACTOR * plain, f32_bound(torch, faces64))
            why = f" (against plain float64; {FVWALL_F32_FACTOR}x plain float32's {plain:.3e})"
        if what == "fvwall" and not f64 and fv64 is None:
            say(f"[{tag} parity] {label}: {name} ({what}) float32 {sol.grid_shape}: "
                f"max_abs_err {err:.3e} against plain float32, max|plain| "
                f"{ref.abs().max().item():.3e}: not held here")
            continue
        if what == "fvwall" and not f64:
            err, limit, _ = fvwall_f32_check(torch, sol, got, ref, fv64)
        ok = err <= limit
        say(f"[{tag} parity] {label}: {name} ({what}) {str(u.dtype)[6:]} {sol.grid_shape}: "
            f"max_abs_err {err:.3e} limit {limit:.3e}{why} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the 2-D {name} ({what}) disagrees with its plain version ({label})")
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


def stages_2d(torch, sol, cu, u, dt):
    """Each 2-D kernel and the stage and step against its plain version on
    ``u``: ``[(name, what, got, ref)]`` (the predictor's new state and
    faces, and a walled viscous solver's wall planes, F̂'s rows with flux
    and with walls the side tensor, the update, the stage with its face
    fluxes, a step)."""
    new_k, faces_k, fv_k = cu.predictor_volume(u, dt)
    new_p, faces_p, fv_p = sol.predictor_volume(u, dt)
    fhat_k, fwall_k = cu.face_flux(faces_p, fv_p)
    fshape = sol.face_flux_shape
    rows = sol.visc_wall_rows(fv_p) if fv_p is not None else {}
    fhat_p, walls = [], {}
    for d in range(sol.dim):
        q_lo, q_hi, f_lo, f_hi = (faces_p[d, k].reshape(fshape) for k in range(4))
        fv_lo, fv_hi = rows.get(d, (None, None))
        fhat_p.append(sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d, fv_hi))
        if sol.is_wall(d):
            walls[d] = sol.low_wall_flux(q_lo, f_lo, d, fv_lo)
    fhat_p = torch.stack(fhat_p).view(fhat_k.shape)
    side = torch.cat([walls[d].reshape(-1) for d in sorted(walls)]) if walls else None
    upd_k = cu.surface_update(new_p.clone(), fhat_p, dt, side)
    upd_p = plain_surface_update(sol, new_p, fhat_p, dt, walls)
    stage_k, fl_k = cu.face_surface(new_p.clone(), faces_p, dt, True, fv_p)
    stage_p, fl_p = sol.face_surface(new_p, faces_p, dt, True, fv_p)
    step_k, step_p = cu.step(u, dt), sol.step(u, dt)
    torch.cuda.synchronize()
    rows = cu._flux_rows  # F̂'s frozen rows after them are left unwritten
    out = [(cu.kernels[0], "new", new_k, new_p), (cu.kernels[0], "faces", faces_k, faces_p)]
    out += [(cu.kernels[0], "fvwall", fv_k, fv_p)] if fv_p is not None else []
    out += [(cu.kernels[1], "fhat", fhat_k[:, :, :rows], fhat_p[:, :, :rows])]
    out += [(cu.kernels[1], f"fwall[{d}]", cu.wall_fluxes(fwall_k)[d], walls[d]) for d in walls]
    out += [(cu.kernels[2], "new", upd_k, upd_p), ("face stage", "new", stage_k, stage_p)]
    out += [("face stage", f"face fluxes[{d}]", a, b) for d, (a, b) in enumerate(zip(fl_k, fl_p))]
    return out + [("step", "new", step_k, step_p)]


def blast_walls_path(torch, dev, card) -> list[dict]:
    """``examples/limited_blast_walls.py`` on the card: the 2-D kernels
    against plain, the example at its own grid and at (1024, 1024), with
    the times; returns the kernel JSON lines of the 2-D kernels."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import (
        ADERDGSolver,
        euler_physics,
        euler_reflect,
        euler_reflect_flux,
        make_dirichlet_fn,
    )
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    flux, eig = euler_physics(2, n_real=4)
    adm = euler_admissible(2)
    mirror = dict(reflect_fn=euler_reflect(2), reflect_flux_fn=euler_reflect_flux(2))

    def held(*x):
        rho = 1.0 + 0.2 * np.sin(2 * np.pi * x[0]) * np.cos(np.pi * x[1])
        vel = (0.3 + 0.1 * np.cos(2 * np.pi * x[1]), -0.2 + 0.1 * np.sin(np.pi * x[0]))
        e = (2.0 + 0.1 * np.sin(np.pi * x[1])) / 0.4 + 0.5 * rho * sum(v * v for v in vel)
        return np.stack([rho, rho * vel[0], rho * vel[1], e], axis=-1)

    def walls_of(name, grid):
        return {
            "periodic": {},
            "reflective box": dict(boundary="reflective", **mirror),
            "reflective (1,)": dict(boundary="reflective", wall_axes=(1,), **mirror),
            "outflow (0,)": dict(boundary="outflow", wall_axes=(0,)),
            "farfield (0,)": dict(boundary="farfield", farfield_state=(1.0, 2.0, 0.0, 4.5),
                                  wall_axes=(0,)),
            "dirichlet box": dict(boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(
                held, dim=2, order=ORDER, grid_shape=grid, dx=1.0 / grid[0])),
        }[name]

    def make(grid, dtype, name="reflective box", **opts):
        sol = ADERDGSolver(2, ORDER, 4, grid, flux, eig, dx=1.0 / grid[0], device=dev,
                           dtype=dtype, **walls_of(name, grid))
        cu = CudaADERDG(sol)
        return (sol, cu, LimitedADERDG(sol, adm, accelerator=cu, device=dev, **opts),
                LimitedADERDG(sol, adm, device=dev, **opts))

    # ---------------------------------- 3. f64 on the cut grid, every mode
    rng = np.random.default_rng(4)
    for name in ("periodic", "reflective box", "reflective (1,)", "outflow (0,)",
                 "farfield (0,)", "dirichlet box"):
        sol, cu, _, _ = make(BLAST_CUT, torch.float64, name)
        u = blast_state(torch, sol, torch.float64)
        u = u * (1.0 + 0.05 * torch.from_numpy(rng.random(u.shape)).to(u))
        parity_2d(torch, sol, cu, u, 0.5 * float(sol.cfl_dt(u)), name, "blast")
    # The whole-grid means fallback, and the Dirichlet whole-grid subcell
    # step, against the plain limiter (f64, 2 steps each).
    for name, opts in (("reflective box, fallback='means'", dict(fallback="means")),
                       ("dirichlet box, fallback='subcell'", {})):
        sol, cu, lim, plain = make(BLAST_CUT, torch.float64, name.split(",")[0], **opts)
        a = b = blast_state(torch, sol, torch.float64)
        dt = 0.5 * float(sol.cfl_dt(a))
        for k in range(2):
            mask = plain.troubled_mask(b, sol.step(b, dt))
            a, b = lim.step(a, dt), plain.step(b, dt)
            torch.cuda.synchronize()
            err = max_err(torch, a, b)
            say(f"[blast parity] {name} f64 {BLAST_CUT}, step {k + 1}: troubled cells "
                f"{int(mask.sum())}; limited step kernel path vs plain path max_abs_err "
                f"{err:.3e} (limit {F64_ATOL:.0e})")
            if not (err <= F64_ATOL and bool(mask.any())):
                fail(f"the whole-grid limited step ({name}) disagrees with the plain limiter, "
                     "or troubled no cell")
    del sol, cu, lim, plain, u, a, b

    lines, gib = [], 2.0**-30
    for grid in BLAST_GRIDS:
        big = grid != BLAST_GRIDS[0]
        sol, cu, lim, plain = make(grid, torch.float32)
        u0 = blast_state(torch, sol, torch.float32)
        dt = float(cu.cfl_dt(u0)) if big else BLAST_DT
        steps = STEPS if big else BLAST_STEPS
        origin = "cfl_dt of the initial state" if big else "the example's"
        say(f"[blast walls] {grid} f32, {sol.dofs()} DOF, reflective box, whole-grid subcell "
            f"fallback: dt = {dt!r} ({origin}), {steps} steps; kernels {cu.kernels}")
        errs = parity_2d(torch, sol, cu, u0, dt, "reflective box", "blast") if big else {}
        frac = lim.troubled_mask(u0, cu.step(u0, dt)).double().mean().item()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cu.reset_launches()
        u = lim.run(u0, steps, dt)
        torch.cuda.synchronize()
        launches = dict(cu.launches)
        peak = torch.cuda.max_memory_allocated()
        say(f"[blast walls main] {steps} steps of {grid} f32 through LimitedADERDG("
            f"accelerator=CudaADERDG): launches {launches}; peak {peak * gib:.4f} GiB allocated "
            f"of {torch.cuda.get_device_properties(0).total_memory * gib:.1f} GiB ({card})")
        if launches != {name: steps for name in cu.kernels}:
            fail(f"the 2-D limited step launched {launches} in {steps} steps, expected 3 a step")
        finite, admissible = bool(torch.isfinite(u).all()), bool(adm(u, sol.var_axis).all())
        m0, m1 = sol.total_mass(u0.double()), sol.total_mass(u.double())
        rel = ((m1 - m0).abs() / m0.abs()).tolist()
        say(f"[blast walls main] {grid}: finite {finite}, admissible {admissible}; troubled "
            f"fraction on step 1 {frac!r}; relative drift over {steps} steps: mass "
            f"{rel[0]:.3e}, energy {rel[3]:.3e} (gates of examples/limited_blast_walls.py: "
            f"admissible, drifts below {MASS_RTOL:.0e} in f32, fraction above 0)")
        if not (tuple(u.shape) == sol.state_shape and finite and admissible and frac > 0
                and rel[0] < MASS_RTOL and rel[3] < MASS_RTOL):
            fail(f"the limited blast in a closed box misses the example's gates at {grid}")
        if not big:
            del sol, cu, lim, plain, u0, u
            continue
        if not torch.equal(u, lim.run(u0, steps, dt)):
            fail("two limited blast runs from the same state differ")
        mask_k = lim.troubled_mask(u, cu.step(u, dt))
        mask_p = plain.troubled_mask(u, sol.step(u, dt))
        torch.cuda.reset_peak_memory_stats()
        step_k, step_p = lim.step(u, dt), plain.step(u, dt)
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated()
        err, limit = max_err(torch, step_k, step_p), f32_bound(torch, step_p)
        say(f"[blast walls main] two runs bitwise equal; one step from the final state, kernel "
            f"path vs plain path: troubled cells {int(mask_k.sum())} / {int(mask_p.sum())}, "
            f"masks equal {torch.equal(mask_k, mask_p)}; state max_abs_err {err:.3e} limit "
            f"{limit:.3e}; peak of the two steps {plain_peak * gib:.4f} GiB")
        if not (torch.equal(mask_k, mask_p) and err <= limit):
            fail("the 2-D limited kernel path disagrees with the plain path")
        del mask_k, mask_p, step_k, step_p

        # The periodic twin: the same blast with the 2-D periodic pair.
        psol, pcu, plim, _ = make(grid, torch.float32, "periodic")
        perrs = parity_2d(torch, psol, pcu, u0, dt, "periodic", "blast")
        pcu.reset_launches()
        pu = plim.run(u0, 3, dt)
        torch.cuda.synchronize()
        p_launches = dict(pcu.launches)
        say(f"[blast walls main] periodic twin, 3 limited steps of {grid} f32: launches "
            f"{p_launches}; finite {bool(torch.isfinite(pu).all())}")
        if p_launches != {name: 3 for name in pcu.kernels} or not torch.isfinite(pu).all():
            fail("the periodic 2-D limited step did not launch its kernels or is not finite")
        del pu

        # ------------------------------ times
        dofs = sol.dofs()
        for label, solver, n_steps, n_win in (("kernel path", lim, STEPS, 3),
                                              ("plain path", plain, 2, 1)):
            win = windows(torch, solver, u0, dt, steps=n_steps, n_windows=n_win)
            ms = [1e3 * w for w in win]
            say(f"[blast walls time] {grid} {label}: step ms per window {ms!r}; median "
                f"{statistics.median(ms)!r} ms, {dofs / statistics.median(win)!r} "
                f"DOF-updates/s ({dofs} DOF per step; {card})")
        times, kernel_lines = {}, []
        for s_, c_ in ((sol, cu), (psol, pcu)):
            new, faces, _ = c_.predictor_volume(u0, dt)
            fhat, fwall = c_.face_flux(faces)
            walls = {} if fwall is None else c_.wall_fluxes(fwall)
            times[c_.kernels[0]] = (
                event_ms(torch, lambda: c_.predictor_volume(u0, dt), 10),
                event_ms(torch, lambda: s_.predictor_volume(u0, dt), 2))
            times[c_.kernels[1]] = (
                event_ms(torch, lambda: c_.face_flux(faces), 10),
                event_ms(torch, lambda: plain_face_flux(torch, s_, faces), 2))
            times[c_.kernels[2]] = (
                event_ms(torch, lambda: c_.surface_update(new, fhat, dt, fwall), 10),
                event_ms(torch, lambda: plain_surface_update(s_, new, fhat, dt, walls), 2))
            del new, faces, fhat, fwall, walls
        cand, dg_fl = cu.step(u0, dt, return_face_fluxes=True)
        mask = lim.troubled_mask(u0, cand)
        fb, fv = lim.subcell_fv_step(u0, dt, return_face_fluxes=True)
        matched = lim._match_interface_fluxes(cand, dg_fl, fv, mask, dt)
        stage_ms = {
            "candidate (3 launches)": event_ms(
                torch, lambda: cu.step(u0, dt, return_face_fluxes=True), 10),
            "troubled_mask": event_ms(torch, lambda: lim.troubled_mask(u0, cand), 5),
            "subcell_fv_step (the eager whole-grid fallback)": event_ms(
                torch, lambda: lim.subcell_fv_step(u0, dt, return_face_fluxes=True), 5),
            "_match_interface_fluxes": event_ms(
                torch, lambda: lim._match_interface_fluxes(cand, dg_fl, fv, mask, dt), 5),
            "merge and guard": event_ms(torch, lambda: lim._admissibility_scale(
                torch.where(mask, fb, matched)), 5),
            "whole step": event_ms(torch, lambda: lim.step(u0, dt), 5),
        }
        say(f"[blast walls time] {grid} the step's stages (CUDA events): " + ", ".join(
            f"{k} {v!r} ms" for k, v in stage_ms.items()) + f"; the kernels alone: " + ", ".join(
            f"{k} {v[0]!r} ms (plain {v[1]!r} ms)" for k, v in times.items()) + f" ({card})")
        del cand, dg_fl, mask, fb, fv, matched
        idle, busy, wall = idle_share(torch, lambda: lim.run(u0, STEPS, dt))
        say(f"[blast walls idle] {grid} kernel path, {STEPS} steps under torch.profiler: device "
            f"busy {busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")

        # ------------------------------ bounds
        ncell = math.prod(grid)
        itemsize = u0.element_size()
        face_bytes = torch.empty(sol.face_shape, dtype=u0.dtype, device="meta").nbytes
        side = cu.walls["size"] * itemsize
        low = cu.walls["size"] // sol.n_vars
        rusanov = 2 * EIG_OPS_2D + 6 * 4
        kw = dict(dim=2, nvar=4)
        work = {
            "predictor": (2 * u0.nbytes + face_bytes,
                          predictor_ops(ORDER, sol.picard_iters, ncell, flux_ops=FLUX_OPS_2D, **kw)),
            "flux": (face_flux_bytes(ORDER, ncell, itemsize, rows=4, **kw),
                     face_flux_ops(ORDER, ncell, eig_ops=EIG_OPS_2D, **kw)),
            "update": (surface_update_bytes(ORDER, ncell, itemsize, dim=2, rows=4),
                       surface_update_ops(ORDER, ncell, **kw)),
        }
        for c_, count, kerrs in ((cu, launches, errs), (pcu, p_launches, perrs)):
            walled = c_ is cu
            for name, (n_bytes, n_ops) in zip(c_.kernels, work.values()):
                if walled and name != c_.kernels[0]:
                    n_bytes += side
                    n_ops += low * rusanov if name == c_.kernels[1] else 0
                if not walled and name == c_.kernels[0]:
                    continue  # the same predictor as the walled step's
                bnd = kernel_report(c_, name, torch.float32,
                                    f"(2-D Euler p3, {'reflective box' if walled else 'periodic'})"
                                    f" {grid} f32", times[name][0], n_bytes, n_ops, card)
                lines.append(kernel_line(name, "exahype_tpu/models/aderdg_pallas.py:156",
                                         count[name], kerrs[name], *times[name], bnd,
                                         source="exahype_tpu_torch/csrc/aderdg_2d.cu"))
        del sol, cu, lim, plain, psol, pcu, plim, u0, u
        torch.cuda.empty_cache()
    return lines


def shock_state(torch, solver, dtype):
    """``examples/viscous_shock.py:50-59``: the slab 0.25 < x < 0.75 at (ρ,
    p) = (1, 1), (0.125, 0.1) outside, at rest (γ = 1.4)."""
    import numpy as np

    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    x = np.broadcast_to(np.squeeze(solver.nodes_meshgrid()[0], va), no_var)
    inside = (x > 0.25) & (x < 0.75)
    rho = np.where(inside, 1.0, 0.125)
    p = np.where(inside, 1.0, 0.1)
    z = np.zeros_like(x)
    q = np.stack([rho, z, z, p / 0.4], axis=va)
    return torch.from_numpy(np.ascontiguousarray(q)).to(solver.weights.device, dtype)


def ns2d_solver(torch, dev, grid, dtype, mu):
    """A periodic 2-D p3 solver on the unit-wide box, dx = 1/g0: Navier–Stokes
    (Pr 0.7) for μ > 0, Euler for μ = 0 (the example builds its inviscid run
    without the viscous callbacks), with its ``CudaADERDG``."""
    from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.navier_stokes import navier_stokes

    kw = {}
    if mu > 0:
        flux, eig, visc, visc_eig = navier_stokes(2, mu=mu, prandtl=SHOCK_PRANDTL)
        kw = dict(visc_flux_fn=visc, visc_eigenvalue_fn=visc_eig)
    else:
        flux, eig = euler_physics(2, n_real=4)
    sol = ADERDGSolver(2, ORDER, 4, grid, flux, eig, dx=1.0 / grid[0], device=dev, dtype=dtype,
                       **kw)
    return sol, CudaADERDG(sol)


def viscous_shock_path(torch, dev, card) -> list[dict]:
    """``examples/viscous_shock.py`` on the card: the 2-D Navier–Stokes
    kernels against plain, the example at its own grid for both
    viscosities with its gates, and at (1024, 1024) with the times; returns
    the kernel JSON lines of the 2-D viscous predictor and face pair."""
    import numpy as np

    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    adm = euler_admissible(2)

    def make(grid, dtype, mu=SHOCK_MU):
        sol, cu = ns2d_solver(torch, dev, grid, dtype, mu)
        return (sol, cu, LimitedADERDG(sol, adm, fallback_order=2, accelerator=cu, device=dev),
                LimitedADERDG(sol, adm, fallback_order=2, device=dev))

    # ---------------------------------- 3. f64 on the cut grid and the example's
    rng = np.random.default_rng(6)
    for grid in (BLAST_CUT, SHOCK_GRIDS[0]):
        sol, cu, _, _ = make(grid, torch.float64)
        u = shock_state(torch, sol, torch.float64)
        noisy = u * (1.0 + 0.05 * torch.from_numpy(rng.random(u.shape)).to(u))
        noisy[:, :, 1:3] += 0.1 * torch.from_numpy(rng.standard_normal(
            noisy[:, :, 1:3].shape)).to(u)
        parity_2d(torch, sol, cu, noisy, 0.5 * float(sol.cfl_dt(noisy)), "noisy shock tube",
                    "shock")
    del sol, cu, u, noisy

    # ---------------------------------- 4. the example's run, f64 (64, 4)
    grid = SHOCK_GRIDS[0]
    vsol, _ = ns2d_solver(torch, dev, grid, torch.float64, SHOCK_MU)
    dt = 0.5 * float(vsol.cfl_dt(shock_state(torch, vsol, torch.float64)))
    results = {}
    for mu in (0.0, SHOCK_MU):
        sol, cu, lim, plain = make(grid, torch.float64, mu)
        u0 = shock_state(torch, sol, torch.float64)
        troubled = lim.troubled_mask(u0, cu.step(u0, dt)).double().mean().item()
        a = b = u0
        for k in range(3):
            a, b = lim.step(a, dt), plain.step(b, dt)
        torch.cuda.synchronize()
        err = max_err(torch, a, b)
        cu.reset_launches()
        t0 = time.perf_counter()
        u = lim.run(u0, SHOCK_STEPS, dt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(cu.launches)
        drift = (sol.total_mass(u) - sol.total_mass(u0)).abs().max().item()
        admissible = bool(adm(u, sol.var_axis).all())
        ke = float((0.5 * (u[:, :, 1] ** 2 + u[:, :, 2] ** 2) / u[:, :, 0]).sum())
        results[mu] = u
        tag = "inviscid" if mu == 0 else f"mu={mu}"
        say(f"[shock main] {grid} f64 {tag}: dt = {dt!r} (half the viscous solver's cfl_dt), "
            f"{SHOCK_STEPS} steps through LimitedADERDG(fallback_order=2, accelerator="
            f"CudaADERDG) in {secs:.2f} s: kernels {cu.kernels}, launches {launches}; troubled "
            f"fraction on step 1 {troubled!r}; conservation drift {drift:.3e} (gate "
            f"{SHOCK_DRIFT:.0e}); admissible {admissible}; KE {ke!r}; 3 steps against the "
            f"plain limiter max_abs_err {err:.3e} (limit {F64_ATOL:.0e})")
        if launches != {name: SHOCK_STEPS for name in cu.kernels}:
            fail(f"the viscous shock ({tag}) launched {launches} in {SHOCK_STEPS} steps")
        if not (drift < SHOCK_DRIFT and admissible and err <= F64_ATOL):
            fail(f"the viscous shock ({tag}) misses the example's gates or the plain limiter")
        if mu == 0 and not troubled > 0:
            fail("the limiter did not fire on the inviscid shock tube")
    dmax = max_err(torch, results[0.0], results[SHOCK_MU])
    say(f"[shock main] viscosity acted through the limited path: max state difference "
        f"{dmax:.3e} (gate > {SHOCK_DMAX:.0e})")
    if not dmax > SHOCK_DMAX:
        fail("the viscous and inviscid shock tubes do not differ")
    del results, sol, cu, lim, plain, u0, u, a, b

    # ---------------------------------- (1024, 1024) f32
    grid = SHOCK_GRIDS[1]
    gib = 2.0**-30
    sol, cu, lim, plain = make(grid, torch.float32)
    u0 = shock_state(torch, sol, torch.float32)
    dt = 0.5 * float(cu.cfl_dt(u0))
    say(f"[shock] {grid} f32, {sol.dofs()} DOF, μ = {SHOCK_MU}, MUSCL whole-grid fallback: dt "
        f"= {dt!r} (half of cfl_dt), {STEPS} steps; kernels {cu.kernels}")
    errs = parity_2d(torch, sol, cu, u0, dt, "shock tube", "shock")
    frac = lim.troubled_mask(u0, cu.step(u0, dt)).double().mean().item()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cu.reset_launches()
    # The first TIME_STEPS steps apart: the repeat runs them again.
    u_first = lim.run(u0, TIME_STEPS, dt)
    u = lim.run(u_first, STEPS - TIME_STEPS, dt)
    torch.cuda.synchronize()
    launches = dict(cu.launches)
    peak = torch.cuda.max_memory_allocated()
    say(f"[shock main] {STEPS} steps of {grid} f32: launches {launches}; peak {peak * gib:.4f} "
        f"GiB allocated ({held * gib:.4f} GiB held before) of "
        f"{torch.cuda.get_device_properties(0).total_memory * gib:.1f} GiB ({card})")
    if launches != {name: STEPS for name in cu.kernels}:
        fail(f"the 2-D viscous limited step launched {launches} in {STEPS} steps")
    finite, admissible = bool(torch.isfinite(u).all()), bool(adm(u, sol.var_axis).all())
    m0, m1 = sol.total_mass(u0.double()), sol.total_mass(u.double())
    rel = ((m1 - m0).abs() / m0.abs()).tolist()
    say(f"[shock main] {grid}: finite {finite}, admissible {admissible}; troubled fraction on "
        f"step 1 {frac!r}; relative drift over {STEPS} steps: mass {rel[0]:.3e}, energy "
        f"{rel[3]:.3e} (limit {MASS_RTOL:.0e} in f32)")
    if not (finite and admissible and frac > 0 and rel[0] < MASS_RTOL and rel[3] < MASS_RTOL):
        fail(f"the viscous shock misses its gates at {grid}")
    if not torch.equal(u_first, lim.run(u0, TIME_STEPS, dt)):
        fail("two viscous shock runs from the same state differ")
    mask_k = lim.troubled_mask(u, cu.step(u, dt))
    mask_p = plain.troubled_mask(u, sol.step(u, dt))
    step_k = lim.step(u, dt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_p = plain.step(u, dt)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    err, limit = max_err(torch, step_k, step_p), f32_bound(torch, step_p)
    say(f"[shock main] the first {TIME_STEPS} steps run twice bitwise equal; one step from the "
        f"final state, kernel path vs "
        f"plain path: troubled cells {int(mask_k.sum())} / {int(mask_p.sum())}, masks equal "
        f"{torch.equal(mask_k, mask_p)}; state max_abs_err {err:.3e} limit {limit:.3e}; peak of "
        f"the plain step {plain_peak * gib:.4f} GiB")
    if not (torch.equal(mask_k, mask_p) and err <= limit):
        fail("the 2-D viscous limited kernel path disagrees with the plain path")
    del mask_k, mask_p, step_k, step_p, u, u_first

    # ------------------------------ times
    dofs = sol.dofs()
    step_ms = {}
    for label, solver, n_steps, n_win in (("kernel path", lim, TIME_STEPS, 3),
                                          ("plain path", plain, 1, 1)):
        win = windows(torch, solver, u0, dt, steps=n_steps, n_windows=n_win)
        ms = [1e3 * w for w in win]
        step_ms[label] = statistics.median(ms)
        say(f"[shock time] {grid} {label}: step ms per window {ms!r}; median "
            f"{statistics.median(ms)!r} ms, {dofs / statistics.median(win)!r} DOF-updates/s "
            f"({dofs} DOF per step; {card})")
    new, faces, _ = cu.predictor_volume(u0, dt)
    fhat, _ = cu.face_flux(faces)
    times = {
        cu.kernels[0]: (event_ms(torch, lambda: cu.predictor_volume(u0, dt), 10),
                        event_ms(torch, lambda: sol.predictor_volume(u0, dt), 2)),
        cu.kernels[1]: (event_ms(torch, lambda: cu.face_flux(faces), 10),
                        event_ms(torch, lambda: plain_face_flux(torch, sol, faces), 2)),
        cu.kernels[2]: (event_ms(torch, lambda: cu.surface_update(new, fhat, dt), 10),
                        event_ms(torch, lambda: plain_surface_update(sol, new, fhat, dt), 2)),
    }
    del new, faces, fhat
    cand, dg_fl = cu.step(u0, dt, return_face_fluxes=True)
    mask = lim.troubled_mask(u0, cand)
    fb, fv = lim.subcell_fv_step(u0, dt, return_face_fluxes=True)
    matched = lim._match_interface_fluxes(cand, dg_fl, fv, mask, dt)
    stage_ms = {
        "candidate (3 launches)": event_ms(
            torch, lambda: cu.step(u0, dt, return_face_fluxes=True), 10),
        "troubled_mask": event_ms(torch, lambda: lim.troubled_mask(u0, cand), 5),
        "subcell_fv_step (the eager MUSCL fallback, two stages)": event_ms(
            torch, lambda: lim.subcell_fv_step(u0, dt, return_face_fluxes=True), 3),
        "_match_interface_fluxes": event_ms(
            torch, lambda: lim._match_interface_fluxes(cand, dg_fl, fv, mask, dt), 5),
        "merge and guard": event_ms(torch, lambda: lim._admissibility_scale(
            torch.where(mask, fb, matched)), 5),
        "whole step": event_ms(torch, lambda: lim.step(u0, dt), 3),
    }
    say(f"[shock time] {grid} the step's stages (CUDA events): " + ", ".join(
        f"{k} {v!r} ms" for k, v in stage_ms.items()) + "; the kernels alone: " + ", ".join(
        f"{k} {v[0]!r} ms (plain {v[1]!r} ms)" for k, v in times.items()) + f" ({card})")
    del cand, dg_fl, mask, fb, fv, matched
    idle, busy, wall = idle_share(torch, lambda: lim.run(u0, TIME_STEPS, dt))
    say(f"[shock idle] {grid} kernel path, {TIME_STEPS} steps under torch.profiler: device busy "
        f"{busy!r} ms of wall {wall!r} ms; idle share {idle!r} ({card})")

    # ------------------------------ bounds
    ncell = math.prod(grid)
    itemsize = u0.element_size()
    face_bytes = torch.empty(sol.face_shape, dtype=u0.dtype, device="meta").nbytes
    kw = dict(dim=2, nvar=4)
    work = {
        cu.kernels[0]: (2 * u0.nbytes + face_bytes,
                        visc_predictor_ops_2d(ORDER, sol.picard_iters, ncell)),
        cu.kernels[1]: (face_flux_bytes(ORDER, ncell, itemsize, rows=4, **kw),
                        face_flux_ops(ORDER, ncell, eig_ops=EIG_OPS_2D, **kw)
                        + ncell * 2 * (ORDER + 1) * NS_PENALTY_OPS),
        cu.kernels[2]: (surface_update_bytes(ORDER, ncell, itemsize, dim=2, rows=4),
                        surface_update_ops(ORDER, ncell, **kw)),
    }
    lines = []
    for name, (n_bytes, n_ops) in work.items():
        bnd = kernel_report(cu, name, torch.float32, f"(2-D Navier–Stokes p3) {grid} f32",
                            times[name][0], n_bytes, n_ops, card)
        title = name if name == cu.kernels[0] else f"{name} (2-D Navier–Stokes)"
        lines.append(kernel_line(title, "exahype_tpu/models/aderdg_pallas.py:156",
                                 launches[name], errs[name], *times[name], bnd,
                                 source="exahype_tpu_torch/csrc/aderdg_2d.cu"))
    del sol, cu, lim, plain, u0
    torch.cuda.empty_cache()
    return lines


def vortex_state(torch, solver, dtype):
    """``examples/navier_stokes_vortex.py:50-57``: the Taylor–Green vortex,
    v = V0 (sin 2πx cos 2πy, −cos 2πx sin 2πy), ρ = p = 1."""
    import numpy as np

    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    x, y = (np.broadcast_to(np.squeeze(c, va), no_var) for c in solver.nodes_meshgrid())
    vx = VORTEX_V0 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)
    vy = -VORTEX_V0 * np.cos(2 * np.pi * x) * np.sin(2 * np.pi * y)
    e = 1.0 / 0.4 + 0.5 * (vx**2 + vy**2)
    q = np.stack([np.ones_like(x), vx, vy, e], axis=va)
    return torch.from_numpy(np.ascontiguousarray(q)).to(solver.weights.device, dtype)


def vortex2d_path(torch, dev, card) -> list[dict]:
    """``examples/navier_stokes_vortex.py`` on the card through
    ``CudaADERDG``: the example's (32, 32) over T = 0.25 with its gates, and
    (1024, 1024) over ``STEPS``, both float64, the kinetic energy's decay
    against the viscous rate; the step timed.  No kernel lines of its own
    (the kernels are the viscous shock path's)."""

    def kinetic(u):
        return float((0.5 * (u[:, :, 1] ** 2 + u[:, :, 2] ** 2) / u[:, :, 0]).sum())

    exact_rate = 4.0 * VORTEX_MU * (2 * math.pi) ** 2
    for grid in VORTEX_GRIDS:
        big = grid != VORTEX_GRIDS[0]
        sol, cu = ns2d_solver(torch, dev, grid, torch.float64, VORTEX_MU)
        u0 = vortex_state(torch, sol, torch.float64)
        dt = float(cu.cfl_dt(u0))
        n = STEPS if big else max(1, round(VORTEX_T / dt))
        cu.reset_launches()
        t0 = time.perf_counter()
        u = cu.run(u0, n, dt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(cu.launches)
        t = n * dt
        k0, k1 = kinetic(u0), kinetic(u)
        rate = math.log(k0 / k1) / t
        decay, exact = 1.0 - k1 / k0, -math.expm1(-exact_rate * t)
        drift = (sol.total_mass(u) - sol.total_mass(u0)).abs().max().item()
        rel_rate, rel_decay = abs(rate - exact_rate) / exact_rate, abs(decay - exact) / exact
        say(f"[vortex] {grid} f64 through CudaADERDG: dt = cfl_dt = {dt!r}, {n} steps (t = "
            f"{t!r}) in {secs:.2f} s; launches {launches}; KE decay rate {rate!r} against "
            f"4ν(2π)² = {exact_rate!r} (relative {rel_rate:.3e}); decay {decay!r} against 1 − "
            f"exp(−4ν(2π)²t) = {exact!r} (relative {rel_decay:.3e}, limit {VORTEX_RTOL}); "
            f"conservation drift {drift:.3e} (limit {VORTEX_DRIFT:.0e})")
        if launches != {name: n for name in cu.kernels} or not torch.isfinite(u).all():
            fail(f"the 2-D vortex at {grid} did not launch its kernels or is not finite")
        if not (rel_rate < VORTEX_RTOL and rel_decay < VORTEX_RTOL and drift < VORTEX_DRIFT):
            fail(f"the 2-D vortex at {grid} misses the example's decay or drift gate")
        if big:
            win = windows(torch, cu, u0, dt, steps=STEPS)
            ms = [1e3 * w for w in win]
            plain_ms = once_ms(torch, lambda: sol.step(u0, dt))
            say(f"[vortex time] {grid} f64 step: ms per window {ms!r}; median "
                f"{statistics.median(ms)!r} ms, {sol.dofs() / statistics.median(win)!r} "
                f"DOF-updates/s; plain step {plain_ms!r} ms ({card})")
        del sol, cu, u0, u
        torch.cuda.empty_cache()
    return []


def ns2w_solver(torch, dev, grid, dtype, order, mode, mu=NS2W_MU, dx=None):
    """A 2-D Navier–Stokes solver (Pr 0.7) at ``order`` on the card in wall
    mode ``mode`` (``periodic``; ``noslip_box``, ``noslip_0``, ``noslip_1``:
    the no-slip hooks on both axes, axis 0, axis 1; ``outflow_0``,
    ``farfield_0`` on axis 0; ``dirichlet`` on both, a smooth flow's rows)
    and its ``CudaADERDG``; dx = 1/g0 on both axes unless given."""
    import numpy as np

    from exahype_tpu_torch.models.aderdg import ADERDGSolver, make_dirichlet_fn
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.navier_stokes import (
        navier_stokes,
        noslip_reflect,
        noslip_reflect_flux,
    )

    def held(*x):
        rho = 1.0 + 0.2 * np.sin(2 * np.pi * x[0]) * np.cos(np.pi * x[1])
        vel = (0.3 + 0.1 * np.cos(2 * np.pi * x[1]), -0.2 + 0.1 * np.sin(np.pi * x[0]))
        e = (2.0 + 0.1 * np.sin(np.pi * x[1])) / 0.4 + 0.5 * rho * sum(v * v for v in vel)
        return np.stack([rho, rho * vel[0], rho * vel[1], e], axis=-1)

    dx = dx or (1.0 / grid[0],) * 2
    noslip = dict(boundary="reflective", reflect_fn=noslip_reflect(2),
                  reflect_flux_fn=noslip_reflect_flux(2))
    walls = {
        "periodic": {},
        "noslip_box": noslip,
        "noslip_0": dict(noslip, wall_axes=(0,)),
        "noslip_1": dict(noslip, wall_axes=(1,)),
        "outflow_0": dict(boundary="outflow", wall_axes=(0,)),
        "farfield_0": dict(boundary="farfield", farfield_state=(1.0, 0.3, 0.0, 2.6),
                           wall_axes=(0,)),
        "dirichlet": dict(boundary="dirichlet", dirichlet_fn=make_dirichlet_fn(
            held, dim=2, order=order, grid_shape=grid, dx=dx)),
    }[mode]
    flux, eig, visc, visc_eig = navier_stokes(2, mu=mu, prandtl=SHOCK_PRANDTL)
    sol = ADERDGSolver(2, order, 4, grid, flux, eig, dx=dx, visc_flux_fn=visc,
                       visc_eigenvalue_fn=visc_eig, device=dev, dtype=dtype, **walls)
    return sol, CudaADERDG(sol)


def ns2w_faces_f64(torch, sol, u, dt, order, mode, mu, rows: int = 128):
    """The plain float64 faces of ``sol``'s predictor on ``u``.  The
    predictor is cell-local, so solvers on bands of ``rows`` cell rows of
    axis 0 (the same dx, order and wall mode) give them at a band's
    memory."""
    g0, g1 = sol.grid_shape
    parts = []
    for r in range(0, g0, rows):
        band, _ = ns2w_solver(torch, u.device, (min(rows, g0 - r), g1), torch.float64, order,
                              mode, mu=mu, dx=tuple(sol.dx))
        part = u.narrow(sol.grid_axis(0), r, band.grid_shape[0]).double()
        parts.append(band.predictor_volume(part, dt)[1])
    return torch.cat(parts, dim=-2)


def ns2w_state(torch, sol, kind: str, dtype, seed: int = 0):
    """A state of ``sol`` made on the card in float64: ``noise`` (random ρ,
    velocity and p at every node, seeded: every gradient of order 1/dx),
    or the JAX tests' ``channel`` (v_y = 1e-3 sin πx), ``box`` (the
    Taylor–Green velocity of 1e-3 in the unit box), ``bump`` (a density
    bump of 0.2 at x = 0.5 at rest), ``smooth`` (the Pallas parity test's
    state) and the 2-D vortex phase's periodic ``vortex``, ρ and p 1 unless
    said."""
    import numpy as np

    dev, va = sol.weights.device, sol.var_axis
    if kind == "noise":
        rng = np.random.default_rng(seed)
        shape = (sol.n_nodes,) * 2 + tuple(sol.grid_shape)
        rho = 1.0 + 0.3 * rng.random(shape)
        vel = [0.3 * rng.standard_normal(shape) for _ in range(2)]
        e = (1.0 + 0.3 * rng.random(shape)) / 0.4 + 0.5 * rho * (vel[0] ** 2 + vel[1] ** 2)
        q = np.stack([rho, rho * vel[0], rho * vel[1], e], axis=va)
        return torch.from_numpy(q).to(dev, dtype).contiguous()
    x, y = (torch.from_numpy(np.squeeze(c, va)).to(dev) for c in sol.nodes_meshgrid())
    one = torch.ones_like(x + y)
    pi = math.pi
    rho, mx, my, p = one, 0.0 * one, 0.0 * one, one
    if kind == "channel":
        my = 1e-3 * torch.sin(pi * x) * one
    elif kind == "box":
        mx = 1e-3 * torch.sin(pi * x) * torch.cos(pi * y)
        my = -1e-3 * torch.cos(pi * x) * torch.sin(pi * y)
    elif kind == "bump":
        rho = (1.0 + 0.2 * torch.exp(-(((x - 0.5) / 0.05) ** 2))) * one
    elif kind == "smooth":
        rho = 1.0 + 0.2 * torch.sin(2 * pi * (x + y))
        mx = 0.2 * torch.cos(2 * pi * x) * one
        my = -0.1 * torch.sin(2 * pi * y) * one
        p = 1.0 + 0.2 * torch.cos(2 * pi * y) * one
    else:  # "vortex"
        mx = VORTEX_V0 * torch.sin(2 * pi * x) * torch.cos(2 * pi * y)
        my = -VORTEX_V0 * torch.cos(2 * pi * x) * torch.sin(2 * pi * y)
    e = p / 0.4 + 0.5 * (mx * mx + my * my) / rho
    return torch.stack([rho, mx, my, e], dim=va).to(dtype).contiguous()


def ns2w_title(cu, name: str) -> str:
    """A kernel's title in this phase's lines: the walled viscous predictor
    is the periodic one's name with the wall planes, the order-3 face pairs
    share their names with the 2-D Euler ones."""
    if name == cu.kernels[0]:
        return name + (" (with the wall planes)" if cu.walls is not None else "")
    return name if "_p2_" in name else f"{name} (2-D Navier–Stokes)"


def ns2d_walls_path(torch, dev, card) -> list[dict]:
    """2-D compressible Navier–Stokes with walls and at order 2 on the card
    (the solvers of the JAX package's viscous-wall and Pallas Navier–Stokes
    tests): the new kernels against plain on ``NS2W_CUT``, the JAX tests'
    three anchors on the kernels in float64, and the timed main runs of
    ``NS2W_RUNS`` at ``NS2W_GRID`` in float32; returns the kernel JSON lines
    of the walled order-3 kernels and of the order-2 ones."""
    f32, f64 = torch.float32, torch.float64
    g0, g1 = NS2W_CUT

    # ------------------------------ kernels against plain on the cut grid
    errs = {}
    cases = [(3, m) for m in NS2W_MODES] + [(2, "periodic")] + [(2, m) for m in NS2W_MODES]
    for order, mode in cases:
        make = dict(order=order, mode=mode, dx=(1.0 / g0, 0.7 / g1))
        sol, cu = ns2w_solver(torch, dev, NS2W_CUT, f64, **make)
        u = ns2w_state(torch, sol, "noise", f64, seed=order)
        dt = 0.5 * float(sol.cfl_dt(u))
        label = f"p{order} {mode}"
        for name, err in parity_2d(torch, sol, cu, u, dt, label, "ns2w").items():
            if name in cu.kernels:
                title = ns2w_title(cu, name)
                errs[title] = max(errs.get(title, 0.0), err)
        if not torch.equal(cu.run(u, 3, dt), cu.run(u, 3, dt)):
            fail(f"two 3-step runs of the 2-D Navier–Stokes kernels ({label}) differ")
        if mode in NS2W_F32_MODES:
            fv = sol.predictor_volume(u, dt)[2]
            fv64 = None if fv is None else sol.visc_wall_rows(fv)
            s32, c32 = ns2w_solver(torch, dev, NS2W_CUT, f32, **make)
            parity_2d(torch, s32, c32, u.float(), dt, label, "ns2w", fv64=fv64)
    say(f"[ns2w parity] {len(cases)} solvers at {NS2W_CUT} in float64 (atol {F64_ATOL:.0e}; "
        f"largest error of each kernel {errs}), {NS2W_F32_MODES} at both orders in float32 "
        f"({F32_ULPS} spacings of max|plain|; the wall planes against plain float64); 3-step "
        "reruns bitwise equal")

    # ------------------------------ the JAX tests' anchors, float64
    def vy_rms(q):
        return float(torch.sqrt(torch.mean((q[:, :, 2] / q[:, :, 0]) ** 2)))

    exact = NS2W_CHANNEL_MU * math.pi**2
    for grid in NS2W_CHANNEL_GRIDS:
        sol, cu = ns2w_solver(torch, dev, grid, f64, 3, "noslip_0", mu=NS2W_CHANNEL_MU)
        u0 = ns2w_state(torch, sol, "channel", f64)
        dt = float(cu.cfl_dt(u0))
        n = max(1, round(1.0 / dt))
        cu.reset_launches()
        u = cu.run(u0, n, dt)
        torch.cuda.synchronize()
        rate = math.log(vy_rms(u0) / vy_rms(u)) / (n * dt)
        rel = abs(rate - exact) / exact
        say(f"[ns2w anchor] no-slip channel {grid} p3 f64 through {cu.kernels}: dt = cfl_dt = "
            f"{dt!r}, {n} steps, launches {dict(cu.launches)}; v_y decay rate {rate!r} against "
            f"ν π² = {exact!r}, relative {rel:.3e} (limit {NS2W_RATE_RTOL})")
        if cu.launches != {name: n for name in cu.kernels} or not rel < NS2W_RATE_RTOL:
            fail(f"the no-slip channel at {grid} misses the JAX test's decay rate")
    sol, cu = ns2w_solver(torch, dev, (8, 8), f64, 2, "noslip_box", mu=0.05)
    u0 = ns2w_state(torch, sol, "box", f64)
    dt = float(cu.cfl_dt(u0))
    u = cu.run(u0, NS2W_BOX_STEPS, dt)
    m0, m1 = float(sol.total_mass(u0)[0]), float(sol.total_mass(u)[0])

    def ke(q):
        return float((0.5 * (q[:, :, 1] ** 2 + q[:, :, 2] ** 2) / q[:, :, 0]).mean())

    ratio = ke(u) / ke(u0)
    say(f"[ns2w anchor] no-slip box (8, 8) p2 f64, μ = 0.05, through {cu.kernels}: "
        f"{NS2W_BOX_STEPS} steps of cfl_dt = {dt!r}; mass drift {abs(m1 - m0):.3e} (limit "
        f"{NS2W_MASS_RTOL:.0e} of {m0!r}); kinetic energy ratio {ratio!r} (limit {NS2W_BOX_KE})")
    if not (torch.isfinite(u).all() and abs(m1 - m0) <= NS2W_MASS_RTOL * m0 + 1e-14
            and ratio < NS2W_BOX_KE):
        fail("the no-slip box misses the JAX test's mass or kinetic-energy gate")
    out_sol, out_cu = ns2w_solver(torch, dev, NS2W_OUTFLOW_GRID, f64, 3, "outflow_0", mu=5e-3)
    per_sol, per_cu = ns2w_solver(torch, dev, NS2W_OUTFLOW_GRID, f64, 3, "periodic", mu=5e-3)
    u0 = ns2w_state(torch, out_sol, "bump", f64)
    diff = max_err(torch, out_cu.run(u0, 3, 5e-4), per_cu.run(u0, 3, 5e-4))
    say(f"[ns2w anchor] outflow walls {NS2W_OUTFLOW_GRID} p3 f64 through {out_cu.kernels}: 3 "
        f"steps of 5e-4 against the periodic kernels, max_abs_err {diff:.3e} (limit "
        f"{F64_ATOL:.0e})")
    if not diff <= F64_ATOL:
        fail("the outflow walls do not give the periodic answer before the bump arrives")
    del sol, cu, out_sol, out_cu, per_sol, per_cu, u0, u

    # ------------------------------ main runs and times, float32
    lines, step_ms = [], {}
    kernel_runs = ("p3 no-slip channel", "p2 periodic", "p2 no-slip box")
    for label, order, mode, kind in NS2W_RUNS:
        sol, cu = ns2w_solver(torch, dev, NS2W_GRID, f32, order, mode, mu=NS2W_CHANNEL_MU)
        u0 = ns2w_state(torch, sol, kind, f32)
        dt = float(cu.cfl_dt(u0))
        cu.reset_launches()
        u = cu.run(u0, TIME_STEPS, dt)
        torch.cuda.synchronize()
        launches = dict(cu.launches)
        if launches != {name: TIME_STEPS for name in cu.kernels}:
            fail(f"the 2-D Navier–Stokes {label} run launched {launches} in {TIME_STEPS} steps")
        if not (torch.isfinite(u).all() and torch.equal(u, cu.run(u0, TIME_STEPS, dt))):
            fail(f"the 2-D Navier–Stokes {label} run is not finite or not repeatable")
        win = [1e3 * w for w in windows(torch, cu, u0, dt, steps=TIME_STEPS)]
        step_ms[label] = statistics.median(win)
        pred_ms = event_ms(torch, lambda: cu.predictor_volume(u0, dt), 10)
        say(f"[ns2w time] {label} {NS2W_GRID} f32, {sol.dofs()} DOF, {cu.kernels}, launches "
            f"{launches} over {TIME_STEPS} steps, finite, rerun bitwise: step ms per window "
            f"{win!r}, median {step_ms[label]!r} ({step_ms[label] / step_ms['p3 periodic']!r}x "
            f"the p3 periodic step), {sol.dofs() / step_ms[label] * 1e3!r} DOF-updates/s; "
            f"predictor {pred_ms!r} ms ({pred_ms / step_ms[label]:.3f} of the step) ({card})")
        if label not in kernel_runs:
            del sol, cu, u0, u
            continue
        new, faces, fv = cu.predictor_volume(u0, dt)
        fhat, fwall = cu.face_flux(faces, fv)
        walls = cu.wall_fluxes(fwall) if fwall is not None else None
        rows = sol.visc_wall_rows(fv) if fv is not None else {}

        def plain_flux():
            fshape = sol.face_flux_shape
            for d in range(2):
                q_lo, q_hi, f_lo, f_hi = (faces[d, k].reshape(fshape) for k in range(4))
                fv_lo, fv_hi = rows.get(d, (None, None))
                sol.interface_flux(q_lo, q_hi, f_lo, f_hi, d, fv_hi)
                if sol.is_wall(d):
                    sol.low_wall_flux(q_lo, f_lo, d, fv_lo)

        times = {
            cu.kernels[0]: (pred_ms, event_ms(torch, lambda: sol.predictor_volume(u0, dt), 1)),
            cu.kernels[1]: (event_ms(torch, lambda: cu.face_flux(faces, fv), 10),
                            event_ms(torch, plain_flux, 1)),
            cu.kernels[2]: (event_ms(torch, lambda: cu.surface_update(new, fhat, dt, fwall), 10),
                            event_ms(torch, lambda: plain_surface_update(
                                sol, new, fhat, dt, walls), 1)),
        }
        # The kernels against plain on this run's state.  Float32 rounds the
        # heat flux κ∂T (from E ≈ 2.5 over dx = 1/1024) at ~1e-5 on the plain
        # path too, so the predictor's faces are held against plain float64.
        # Its wall planes are only printed: at velocities of 1e-3 their
        # largest value, τ ≈ μπ·1e-3, lies below that rounding, so no limit
        # tells a kernel that drops them; the cut grid holds them.
        faces64 = ns2w_faces_f64(torch, sol, u0, dt, order, mode, NS2W_CHANNEL_MU)
        full = parity_2d(torch, sol, cu, u0, dt, f"{label}, the timed state", "ns2w",
                         faces64=faces64)
        del faces64
        ncell, itemsize, n = math.prod(NS2W_GRID), u0.element_size(), order + 1
        side = cu.walls["size"] * itemsize if cu.walls is not None else 0
        low = cu.walls["size"] // 4 if cu.walls is not None else 0
        kw = dict(dim=2, nvar=4)
        work = {
            cu.kernels[0]: (2 * u0.nbytes + faces.nbytes + 2 * side,
                            visc_predictor_ops_2d(order, sol.picard_iters, ncell, bool(side))),
            cu.kernels[1]: (face_flux_bytes(order, ncell, itemsize, rows=4, **kw) + 3 * side,
                            face_flux_ops(order, ncell, eig_ops=EIG_OPS_2D, **kw)
                            + (ncell * 2 * n + low) * NS_PENALTY_OPS
                            + low * (2 * EIG_OPS_2D + 6 * 4)),
            cu.kernels[2]: (surface_update_bytes(order, ncell, itemsize, dim=2, rows=4) + side,
                            surface_update_ops(order, ncell, **kw)),
        }
        for name, (n_bytes, n_ops) in work.items():
            title = ns2w_title(cu, name)
            bnd = kernel_report(cu, name, f32, f"(2-D Navier–Stokes, {label}) {NS2W_GRID} f32",
                                times[name][0], n_bytes, n_ops, card)
            lines.append(kernel_line(title, "exahype_tpu/models/aderdg_pallas.py:156",
                                     launches[name], full[name], *times[name], bnd,
                                     source="exahype_tpu_torch/csrc/aderdg_2d.cu"))
        del sol, cu, u0, u, new, faces, fv, fhat, fwall, walls, rows, full
        torch.cuda.empty_cache()
    return lines


#: The multichip phase: the sharded steps of ``parallel/shard.py``.
#: K1 e's f64 parity grid, and the windows each axis is cut into there.
MC_CUT = (8, 4, 8)
#: The wall configurations of K1 e's parity (``euler_walls``; "periodic"
#: has none).
MC_WALLS = ("periodic", "reflective box", "outflow (0,)", "farfield (0,)", "dirichlet box",
            "reflective (1, 2)")
#: The sharded ADER-DG runs at full width: (label, walls, 2-axis mesh).
MC_DG_CASES = (
    ("periodic", {}, False),
    ("reflective on axis 0", dict(boundary="reflective", wall_axes=(0,)), False),
    ("outflow on axes 0 and 1", dict(boundary="outflow", wall_axes=(0, 1)), True),
)
MC_DG_STEPS = 4
MC_FV_GRID = FV_GRIDS[1]
MC_FV_STEPS = 5
#: The 2-D gauge wave of the Z4 runs (``__graft_entry__.py:476-529``'s
#: fused dynamic-GR check, at the bench's width): 38 variables, p2.
MC_Z4_GRID = (256, 128)
MC_Z4_DT = 1e-4
MC_Z4_STEPS = 2
MC_Z4_CUT = (8, 6)
#: Ranks sharing the card over gloo (each a spawned process).
MC_RANKS = 4


def mc_dg_solver(torch, dev, grid, dtype, walls: dict):
    from exahype_tpu_torch.models.aderdg import (
        ADERDGSolver,
        euler_physics,
        euler_reflect,
        euler_reflect_flux,
    )

    walls = dict(walls)
    if walls.get("boundary") == "reflective":
        walls.update(reflect_fn=euler_reflect(3), reflect_flux_fn=euler_reflect_flux(3))
    return ADERDGSolver(3, ORDER, 5, grid, *euler_physics(3, n_real=5), dx=DX, device=dev,
                        dtype=dtype, **walls)


def mc_z4(torch, dev, grid, dtype):
    """The 2-D vacuum Z4 solver (p2, κ₁ = 0.5, κ₂ = 0.1 as the JAX dryrun),
    plain and through K5 b, and the gauge wave with seeded noise."""
    import numpy as np

    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
    from exahype_tpu_torch.models.z4 import gauge_wave_state, make_z4_solver

    plain = make_z4_solver(2, 2, grid, dx=1.0 / grid[0], kappa1=0.5, kappa2=0.1, impl="soa",
                           fused_rhs="soa", device=dev, dtype=dtype)
    rng = np.random.default_rng(7)
    u = gauge_wave_state(plain, amplitude=Z4_AMPLITUDE) + torch.as_tensor(
        1e-4 * rng.standard_normal(plain.state_shape), dtype=dtype, device=dev)
    return plain, with_cuda_rhs(plain), u.contiguous()


def mc_fv(torch, dev, mesh=None):
    from exahype_tpu_torch.models import euler
    from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
    from exahype_tpu_torch.parallel.grid import TpuPatchGrid
    from exahype_tpu_torch.parallel.solver import GridSolver

    kb = build_fv_rusanov_kernel(**FV_WIDTH, n_patches=math.prod(MC_FV_GRID))
    grid = TpuPatchGrid(kb.config, MC_FV_GRID)
    sol = GridSolver(grid, kb, dx=1.0 / (4 * MC_FV_GRID[0]), cfl=FV_CFL,
                     eigenvalue_fn=euler.wave_speed_fn(3), kernel_dt="lambda", device=dev,
                     dtype=torch.float32, mesh=mesh)
    return sol, kb


def mc_runs(torch, dev, mesh1, mesh2, rank: int) -> dict:
    """The sharded main path on this rank: each ADER-DG case, the FV step
    with its global dt on both meshes and the Z4 step through K5 b, the
    launch counters set to 0 just before each and read just after, each
    gathered on rank 0 and held there against the unsharded step bit for
    bit.  Returns ``{case: {"bitwise": ..., "launches": {...}, "steps": n}}``
    (the comparison on rank 0 only)."""
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.parallel import shard

    out = {}
    for label, walls, two in MC_DG_CASES:
        sol = mc_dg_solver(torch, dev, GRID, torch.float32, walls)
        u0 = bench_state(sol, torch, dev, torch.float32)
        dt = float(sol.cfl_dt(u0))
        mesh = mesh2 if two else mesh1
        make = shard.make_sharded_aderdg_step_2axis if two else shard.make_sharded_aderdg_step
        step, sh = make(sol, mesh, mesh.axis_names if two else mesh.axis_names[0])
        u = sh.shard(u0)
        step.accelerator.reset_launches()
        for _ in range(MC_DG_STEPS):
            u = step(u, dt)
        torch.cuda.synchronize()
        launches = {k: v for k, v in step.accelerator.launches.items() if v}
        got = sh.gather(u, dst=0)
        res = {"launches": launches, "steps": MC_DG_STEPS, "modes": step.side_modes}
        if rank == 0:
            ref = CudaADERDG(sol).run(u0, MC_DG_STEPS, dt)
            res.update(bitwise=bool(torch.equal(got, ref)), err=max_err(torch, got, ref),
                       finite=bool(torch.isfinite(got).all()))
        out[f"ADER-DG {label}"] = res
        del sol, u0, u, got, step
        torch.cuda.empty_cache()
    for two in (False, True):
        mesh = mesh2 if two else mesh1
        whole, kb = mc_fv(torch, dev)
        sharded, _ = mc_fv(torch, dev, mesh)
        Q0 = fv_state(torch, MC_FV_GRID, dev, torch.float32)
        make = shard.make_sharded_cuda_step_2axis if two else shard.make_sharded_cuda_step
        axis = mesh.axis_names if two else mesh.axis_names[0]
        step, sh = make(kb, whole.grid, mesh, axis)
        q = sh.shard(Q0)
        step.kernel_fn.launches = 0
        for _ in range(MC_FV_STEPS):
            q = step(q, sharded.compute_dt(q) / whole.dx)
        torch.cuda.synchronize()
        res = {"launches": {"K4 (fv spec)": step.kernel_fn.launches}, "steps": MC_FV_STEPS}
        got = sh.gather(q, dst=0)
        if rank == 0:
            ref, _ = whole.run(Q0, MC_FV_STEPS)
            res.update(bitwise=bool(torch.equal(got, ref)), err=max_err(torch, got, ref),
                       finite=bool(torch.isfinite(got).all()))
        out[f"FV {'2-axis' if two else '1-axis'} with the global dt"] = res
        del whole, sharded, Q0, q, got, step
        torch.cuda.empty_cache()
    plain, kern, u0 = mc_z4(torch, dev, MC_Z4_GRID, torch.float32)
    step, sh = shard.make_sharded_xla_aderdg_step(kern, mesh1, mesh1.axis_names[0])
    k5 = step.local_solver.rhs_all_fn
    u = sh.shard(u0)
    k5.reset_launches()
    for _ in range(MC_Z4_STEPS):
        u = step(u, MC_Z4_DT)
    torch.cuda.synchronize()
    res = {"launches": {k5.kernel: k5.launches}, "steps": MC_Z4_STEPS}
    got = sh.gather(u, dst=0)
    if rank == 0:
        ref = kern.run(u0, MC_Z4_STEPS, MC_Z4_DT)
        res.update(bitwise=bool(torch.equal(got, ref)), err=max_err(torch, got, ref),
                   finite=bool(torch.isfinite(got).all()))
    out["Z4 2-D through K5 b"] = res
    return out


def multichip_rank(rank: int, world: int) -> dict:
    """One of the ranks that share the card over gloo (spawned by
    ``run_ranks``): :func:`mc_runs` on the meshes ``(world,)`` and
    ``(world // 2, 2)``."""
    import torch

    from exahype_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh1 = make_mesh(world, device=dev)
    mesh2 = make_mesh(shape=(world // 2, 2), axis_names=("ici", "dcn"), device=dev)
    return mc_runs(torch, dev, mesh1, mesh2, rank)


def mc_report(runs: dict, where: str):
    """Print each sharded run's line and fail on a disagreement or on a
    kernel of the path launched no time."""
    for case, res in runs.items():
        per_step = {k: v / res["steps"] for k, v in res["launches"].items()}
        say(f"[mc main] {where}: {case}: {res['steps']} steps, gathered on rank 0: bitwise "
            f"{res['bitwise']} against the unsharded step (max_abs_err {res['err']:.3e}), "
            f"launches per step on rank 0 {per_step}"
            + (f", side modes {res['modes']}" if "modes" in res else ""))
        if not (res["bitwise"] and res["finite"]):
            fail(f"the sharded {case} ({where}) is not the unsharded step bit for bit")
        if not res["launches"] or min(res["launches"].values()) < res["steps"]:
            fail(f"a kernel of the sharded {case} ({where}) launched less than once a step: "
                 f"{res['launches']}")


def multichip_path(torch, dev, card) -> list[dict]:
    """The multichip phase: K1 e and K5 b against their plain versions, the
    sharded steps at full width at world size 1 over NCCL (in this process)
    and with 4 ranks sharing the card over gloo (spawned), the readings at
    world size 1."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.parallel import shard
    from exahype_tpu_torch.parallel.mesh import init_group, make_mesh, run_ranks

    # ------------------------------------------- K1 e vs plain, every mode
    k1e_err, f64 = 0.0, torch.float64
    for name in MC_WALLS:
        walls = {} if name == "periodic" else euler_walls(name, MC_CUT)
        sol = mc_dg_solver(torch, dev, MC_CUT, f64, walls)
        cu = CudaADERDG(sol)
        u = bench_state(sol, torch, dev, f64)
        new, faces, _ = cu.predictor_volume(u, 1e-4)
        whole = cu.face_surface(new.clone(), faces, 1e-4)
        worst, same = 0.0, True
        for d in range(3):
            for parts in (1, 2):
                for p in range(parts):
                    local, lf, ln, modes, planes = shard.window_faces(sol, faces, new, d, parts, p)
                    lcu = CudaADERDG(local)
                    fhat, fside = lcu.face_flux_exchanged(lf, modes, planes)
                    got = lcu.surface_update_exchanged(ln.clone(), fhat, 1e-4, fside, modes)
                    ref = shard.exchanged_face_surface(local, ln, lf, 1e-4, modes, planes)
                    n = MC_CUT[d] // parts
                    same = same and bool(torch.equal(
                        got, whole.narrow(sol.grid_axis(d), p * n, n)))
                    worst = max(worst, max_err(torch, got, ref) / max(1.0, ref.abs().max().item()))
        say(f"[mc parity] aderdg_face_flux_exchanged + aderdg_surface_update_walls, {name}, "
            f"float64 {MC_CUT}, each axis in 1 and 2 windows (walls on the windows owning "
            f"them): max_abs_err / max(1, max|plain|) {worst:.3e} limit {F64_ATOL:.1e}; bitwise "
            f"the unsharded kernels' face stage on every window: {same}")
        if not (worst <= F64_ATOL and same):
            fail(f"K1 e disagrees with its plain version or the unsharded stage ({name})")
        k1e_err = max(k1e_err, worst)

    # f32 at full width, axis 0 in 2 windows.
    sol = mc_dg_solver(torch, dev, GRID, torch.float32, {})
    cu = CudaADERDG(sol)
    u0 = bench_state(sol, torch, dev, torch.float32)
    dt = float(cu.cfl_dt(u0))
    new, faces, _ = cu.predictor_volume(u0, dt)
    f32_err = 0.0
    for p in range(2):
        local, lf, ln, modes, planes = shard.window_faces(sol, faces, new, 0, 2, p)
        lcu = CudaADERDG(local)
        fhat, fside = lcu.face_flux_exchanged(lf, modes, planes)
        got = lcu.surface_update_exchanged(ln.clone(), fhat, dt, fside, modes)
        ref = shard.exchanged_face_surface(local, ln, lf, dt, modes, planes)
        err, limit = max_err(torch, got, ref), f32_bound(torch, ref)
        say(f"[mc parity] K1 e float32 {GRID}, window {p} of 2 along axis 0: max_abs_err "
            f"{err:.3e} limit {limit:.3e} ({F32_ULPS} f32 spacings of max|plain|)")
        if not err <= limit:
            fail("K1 e disagrees with its plain version at full width (float32)")
        f32_err = max(f32_err, err)
    del local, lf, ln, planes, fhat, fside, got, ref

    # ------------------------------------------- K5 b vs plain
    k5b_err = 0.0
    for grid, dtype in ((MC_Z4_CUT, f64), (MC_Z4_GRID, torch.float32)):
        plain, kern, u = mc_z4(torch, dev, grid, dtype)
        calls = z4_rhs_calls(plain, u, MC_Z4_DT)
        for i, (Q, grads, va) in enumerate(calls):
            got, ref = kern.rhs_all_fn(Q, grads, va), plain.rhs_all_fn(Q, grads, va)
            err = max_err(torch, got, ref)
            limit = (Z4_F64_RTOL * max(1.0, ref.abs().max().item()) if dtype == f64
                     else f32_bound(torch, ref))
            say(f"[mc parity] rhs_all_z4_2d {str(dtype)[6:]} {grid} call {i} "
                f"{tuple(Q.shape)}: max_abs_err {err:.3e} limit {limit:.3e}")
            if not err <= limit:
                fail(f"K5 b disagrees with its plain version ({dtype}, {grid}, call {i})")
            if dtype == torch.float32:
                k5b_err = max(k5b_err, err)
    pic = calls[0]

    # ------------------------------------------- world size 1, NCCL
    with tempfile.TemporaryDirectory() as tmp:
        init_group(0, 1, "file://" + tmp + "/rendezvous", backend="nccl", device=dev)
        try:
            mesh1 = make_mesh(1, device=dev)
            mesh2 = make_mesh(shape=(1, 1), axis_names=("ici", "dcn"), device=dev)
            runs = mc_runs(torch, dev, mesh1, mesh2, 0)
            mc_report(runs, "world size 1, NCCL")

            # Readings: the sharded step's host windows against CudaADERDG's
            # in the same run, the exchanged pair, the pack and exchange.
            step, sh = shard.make_sharded_aderdg_step(sol, mesh1)

            class Sharded:
                def run(self, u, n, dt):
                    for _ in range(n):
                        u = step(u, dt)
                    return u

            s_win = windows(torch, Sharded(), u0, dt, steps=20)
            c_win = windows(torch, cu, u0, dt, steps=20)
            s_win2 = windows(torch, Sharded(), u0, dt, steps=20)
            for label, win in (("sharded step (mesh (1,), K1 e)", s_win),
                               ("CudaADERDG.step", c_win), ("sharded step, again", s_win2)):
                ms = [1e3 * s for s in win]
                say(f"[mc time] world size 1, NCCL: {label} {GRID} f32: step ms per window "
                    f"{ms!r}; median {statistics.median(ms)!r} ms ({card})")
            acc = step.accelerator
            modes = step.side_modes
            planes = step.exchange_planes(faces)
            fhat, fside = acc.face_flux_exchanged(faces, modes, planes)
            t_flux = event_ms(torch, lambda: acc.face_flux_exchanged(faces, modes, planes), 20)
            def pair():
                fh, fs = acc.face_flux_exchanged(faces, modes, planes)
                return acc.surface_update_exchanged(new.clone(), fh, dt, fs, modes)

            t_pair = event_ms(torch, pair, 20)
            t_clone = event_ms(torch, lambda: new.clone(), 20)
            t_walls = event_ms(torch, lambda: cu.face_surface(new.clone(), faces, dt), 20)
            t_pack = event_ms(torch, lambda: step.exchange_planes(faces), 20)
            t_plain = event_ms(torch, lambda: shard.exchanged_face_surface(
                sol, new, faces, dt, modes, planes), 3)
            say(f"[mc time] world size 1, NCCL, {GRID} f32 (CUDA events): "
                f"aderdg_face_flux_exchanged {t_flux!r} ms; the exchanged pair "
                f"{t_pair - t_clone!r} ms (a clone of new, {t_clone!r} ms, taken out); the "
                f"unsharded periodic pair on the same faces {t_walls - t_clone!r} ms; the pack "
                f"and exchange of axis 0's edge rows (local copy) {t_pack!r} ms; the plain "
                f"pair {t_plain!r} ms ({card})")
        finally:
            dist.destroy_process_group()

    # ------------------------------------------- 4 ranks on the card, gloo
    t0 = time.perf_counter()
    ranks = run_ranks(multichip_rank, MC_RANKS, backend="gloo", device=dev, join_timeout=480.0)
    say(f"[mc main] {MC_RANKS} ranks sharing the card over gloo (the planes staged through "
        f"host memory): spawned and joined in {time.perf_counter() - t0:.1f} s (not a scaling "
        "figure: the ranks share one card)")
    mc_report(ranks[0], f"{MC_RANKS} ranks, gloo, meshes ({MC_RANKS},) and "
              f"({MC_RANKS // 2}, 2)")
    for r, res in enumerate(ranks[1:], 1):
        for case in res:
            if res[case]["launches"] != ranks[0][case]["launches"]:
                fail(f"rank {r} launched {res[case]['launches']} in {case}, rank 0 "
                     f"{ranks[0][case]['launches']}")

    # ------------------------------------------- bounds and kernel lines
    ncell = math.prod(GRID)
    itemsize = u0.element_size()
    nf, plane_cells = (ORDER + 1) ** 2, GRID[1] * GRID[2]
    plane_bytes = 2 * 2 * nf * 5 * plane_cells * itemsize  # two planes, q and f
    side_bytes = nf * 5 * plane_cells * itemsize           # fside written, then read
    flux_work = (face_flux_bytes(ORDER, ncell, itemsize) + plane_bytes + side_bytes,
                 face_flux_ops(ORDER, ncell) + nf * plane_cells * (2 * EIG_OPS + 6 * 5))
    pair_work = (face_stage_bytes(ORDER, ncell, itemsize) + plane_bytes, flux_work[1]
                 + surface_update_ops(ORDER, ncell))
    b_flux = kernel_report(acc, "aderdg_face_flux_exchanged", torch.float32,
                           f"(Euler, axis 0 exchanged, world size 1) {GRID} f32", t_flux,
                           *flux_work, card)
    b_pair = kernel_report(None, "aderdg_face_flux_exchanged + aderdg_surface_update_walls",
                           torch.float32, f"(K1 e's pair) {GRID} f32", t_pair - t_clone,
                           *pair_work, card)
    k5 = kern.rhs_all_fn
    t_k5 = event_ms(torch, lambda: k5(*pic), 20)
    t_k5_plain = event_ms(torch, lambda: plain.rhs_all_fn(*pic), 2)
    q_slots, grad_slots = z4_slots_read(torch, plain.rhs_all_fn)
    Q = pic[0]
    points = Q.numel() // Q.shape[pic[2]]
    # The 2-D algebra reads two of the three gradient directions.
    k5_bytes = itemsize * points * (q_slots + 2 * grad_slots // 3 + Q.shape[pic[2]])
    k5_ops = z4_value_ops(torch, plain.rhs_all_fn, (0, 1)) * points
    b_k5 = bound(k5_bytes, k5_ops)
    say(f"[bound] rhs_all_z4_2d a Picard call {tuple(Q.shape)} f32: {k5_bytes} B ({q_slots} "
        f"state slots and two directions' {2 * grad_slots // 3} gradient slots read, "
        f"{Q.shape[pic[2]]} written), {k5_ops} operations (z4_value_ops with two gradient "
        f"axes): bound {b_k5['bound_ms']!r} ms by {b_k5['bound_by']}; kernel {t_k5!r} ms "
        f"({t_k5 / b_k5['bound_ms']:.2f}x), plain {t_k5_plain!r} ms (CUDA events; {card})")
    replaces = "exahype_tpu/models/aderdg_pallas.py:156"
    flux_launches = runs["ADER-DG periodic"]["launches"]["aderdg_face_flux_exchanged"]
    return [
        # (The plain ms of the flux alone is its pair's: the plain version
        # forms the fluxes inside the surface update.)
        kernel_line("aderdg_face_flux_exchanged (K1 e)", replaces, flux_launches, f32_err,
                    t_flux, t_plain, b_flux),
        kernel_line("aderdg_face_flux_exchanged + aderdg_surface_update_walls (K1 e's pair)",
                    replaces, flux_launches, f32_err, t_pair - t_clone, t_plain, b_pair),
        kernel_line("rhs_all_z4_2d (K5 b)", "exahype_tpu/models/rhs_pallas.py:104",
                    runs["Z4 2-D through K5 b"]["launches"]["rhs_all_z4_2d"], k5b_err, t_k5,
                    t_k5_plain, b_k5, "exahype_tpu_torch/csrc/rhs.cu"),
    ]


def main():
    import torch

    # ---------------------------------------------------------- 1. card
    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False (this script "
             "runs the port's kernels on one NVIDIA GPU)")
    if not (HERE / "exahype_tpu_torch" / "__init__.py").is_file():
        fail(f"exahype_tpu_torch/ not found beside {__file__}; run the script "
             "from a checkout of the repository")
    sys.path.insert(0, str(HERE))
    import exahype_tpu_torch

    if pathlib.Path(exahype_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"imported exahype_tpu_torch from {exahype_tpu_torch.__file__}, "
             f"not from {HERE}")
    from exahype_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain path: full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    import sympy

    say(f"[card] torch.cuda.get_device_name(0) = {kind}; "
        f"device_count = {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, sympy {sympy.__version__}")
    say(f"[card] nvidia-smi name, power.limit: {card}")

    # --------------------------------------------------------- 2. build
    from exahype_tpu_torch.backends.cuda_backend import CudaPrinter
    from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
    from exahype_tpu_torch.models.rusanov import build_rusanov_kernel

    # The K4 source depends on the spec's widths, not on its patch count.
    spec_printers = {
        name: CudaPrinter(build(**FV_WIDTH, n_patches=1))
        for name, build in (("fv", build_fv_rusanov_kernel),
                            ("rusanov", build_rusanov_kernel))
    }
    jobs = {"csrc/*.cu (one library)": _build.compile_library}
    jobs.update({f"K4 {name} spec (generated)": pr.compile
                 for name, pr in spec_printers.items()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {what: pool.submit(job) for what, job in jobs.items()}
        builds = {what: f.result() for what, f in futures.items()}
    say(f"[build] {len(jobs)} nvcc builds in parallel: {time.perf_counter() - t0:.2f} s "
        f"wall; flags {' '.join(_build.NVCC_FLAGS)}")
    for what, info in builds.items():
        say(f"[build] {what}: {info['seconds']:.2f} s -> "
            f"{pathlib.Path(info['path']).relative_to(HERE)} (name carries the "
            "source hash); nvcc seconds per source " + ", ".join(
                f"{name} {sec:.2f}" for name, sec in info["sources"].items()))
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say(f"[build]   {line.strip()}")
    _build.library()
    for pr in spec_printers.values():
        pr.library()

    paths = {
        "ADER-DG": lambda: aderdg_path(torch, dev, card),
        "ADER-DG p4, p5, p7": lambda: st_orders_path(torch, dev, card),
        "limited": lambda: limited_path(torch, dev, card),
        "limited walls": lambda: limited_walls_path(torch, dev, card),
        "limited blast walls": lambda: blast_walls_path(torch, dev, card),
        "viscous shock": lambda: viscous_shock_path(torch, dev, card),
        "2-D vortex": lambda: vortex2d_path(torch, dev, card),
        "2-D Navier–Stokes walls and order 2": lambda: ns2d_walls_path(torch, dev, card),
        "CK": lambda: ck_path(torch, dev, card),
        "seismic": lambda: seismic_path(torch, dev, card),
        "elastic K2 b": lambda: elastic_k2b_path(torch, dev, card),
        "curvilinear and heterogeneous K2 b.1": lambda: k2b1_path(torch, dev, card),
        "walls": lambda: walls_path(torch, dev, card),
        "viscous": lambda: viscous_path(torch, dev, card),
        "FV": lambda: [fv_path(torch, dev, card, spec_printers)],
        "Z4": lambda: z4_path(torch, dev, card),
        "Z4 shifted": lambda: z4_shift_path(torch, dev, card),
        "Z4+GRHD": lambda: z4_matter_path(torch, dev, card),
        "limited Z4+GRHD": lambda: limited_z4_matter_path(torch, dev, card),
        "Z4+GRMHD": lambda: z4_grmhd_path(torch, dev, card),
        "Z4 per-axis and 2-D": lambda: z4_forms_path(torch, dev, card),
        "Z4+GRHD per-axis and 2-D": lambda: z4m_forms_path(torch, dev, card),
        "Z4+GRMHD per-axis and 2-D": lambda: z4g_forms_path(torch, dev, card),
        "Z4 shifted per-axis and 2-D": lambda: z4s_forms_path(torch, dev, card),
        "multichip": lambda: multichip_path(torch, dev, card),
    }
    kernels, seconds = [], {"build": time.perf_counter() - t0}
    for name, run in paths.items():
        t1 = time.perf_counter()
        kernels.extend(run())
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t1
    say("[paths] seconds per phase (host clock): " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": kind,
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
