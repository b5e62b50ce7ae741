"""Smoke run of pygsti_tpu_torch on one NVIDIA card: build, check, fit.

    python3 chip_smoke.py     # needs one CUDA card

Phases, each fatal on failure:
  1. build   -- compile every CUDA source of the package (nvcc, in parallel)
  2. kernels -- each kernel against its plain PyTorch version on the card, at
                the shapes the 2-qubit fit gives it, in float64 and float32,
                also on op indices out of range and bitwise between two
                launches, with times per shape beside the least time the
                card could take, the plain version and a batched-einsum
                yardstick
  3. fit     -- the 2-qubit GST protocol at full width (smq2Q_XYICNOT,
                13,958 circuits, 1,616 parameters, chi2 stages then Poisson
                logL, then the three stages of 'stdgaugeopt') through
                GateSetTomography.run on the card, with checkpoints, and
                with every kernel's launch count over exactly this phase
  4. checks  -- the fitted model's probabilities against a numpy reference,
                the gauge-optimized model's against the fitted model's, and
                the blocked J^T J / J^T f on the card against the CPU path
  5. profile -- device time by kernel of one J^T J / J^T f and one residual
                at the fitted point, from torch.profiler
  6. cptp fit-- the CPTP-constrained fit of the same data at full width
                ('CPTPLND': every member an exponentiated Lindblad error
                generator, 1,920 parameters) through GateSetTomography.run
                from the target, with checkpoints and its own launch count;
                the fitted operations must be CPTP and cannot fit better
                than the 'full' model; and the card's time for the model's
                tensors and their Jacobian beside the 'full' model's
  7. lgst    -- linear-inversion GST on the same data (numpy on the host, as
                in the JAX package), gauge-optimized to the target on the card
  8. instrument fit -- the 2-qubit fit with a mid-circuit Z measurement of
                qubit 0 (a TPInstrument 'Iz:0', 2,112 parameters, 14,310
                circuits expanded to 15,014 rows) through GateSetTomography.run
                from the target, with checkpoints and its own launch count
                (the kernel at K1 = 9); the fitted instrument must stay TP,
                its probabilities match a numpy reference that expands the
                members, and its checkpoint read back with the instrument
  9. sparse  -- phase 3's data on a layout of the observed outcomes only,
                beside the dense one: the omitted-probability correction
                (objective and gradient equal to the dense ones in the
                linear regime), the forward-mode ('linearize') Jacobian on
                the card against the CPU and beside the blocked one (time,
                peak memory), a short LM fit on it, and the penalty rows
 10. parallel layers -- the 2-qubit fit of smq2Q_XXYYII at full width and
                depth (19,590 circuits, depth 70, 'full', 1,360 parameters)
                whose layers [Gxpi2:0Gxpi2:1], [Gxpi2:0Gypi2:1] and
                [Gypi2:0Gypi2:1] are composite slots of the op stack (K1 = 9):
                the kernel against its plain version at every bucket shape
                of this layout, the fit through GateSetTomography.run with
                its own launch count, probabilities against a numpy
                reference that multiplies the components, and a gauge
                transformation that must leave them unchanged
 11. fpr     -- the fiducial-pair-reduced design of smq2Q_XYICNOT
                (create_gst_experiment_design(64, fpr=True), 2,900 circuits
                in its last list, each one of phase 3's), fitted 'full' on
                phase 3's data with its own launch count
 12. qutrit  -- the legacy qutrit pack stdQT_XYIMS at full width and depth
                (all 69 germs, maxL 1..64, 19,971 circuits, 'full TP', 314
                parameters, d 9, three outcomes, K1 5): the kernel against
                its plain version at every bucket shape of this layout, the
                fit through GateSetTomography.run with its own launch count,
                probabilities against a numpy product of the superoperators
                and after a TP gauge transformation, and a circuit of bare
                gate names resolved by the layout
 13. rpe     -- robust phase estimation of an over-rotated Gxpi2 from the
                smq1Q_Xpi2_rpe design (22 circuits, depth up to 1,025): the
                estimate per generation, the card's probabilities at depth
                1,025 against numpy, and the config-driven analysis of
                extras/rpe on card-simulated data
 14. objectives -- on phase 3's data: the frequency-weighted chi2 stages
                and the logL stage through CustomLMOptimizer's host loop on
                the card's tensors; the final list's logL by the device loop
                with the CG and the Cholesky solve; every other raw
                objective on the card against the CPU; an out-of-bounds
                interval without a predicate, bit for bit
 15. cloud5  -- the JAX package's 5-qubit cloud-noise cell (bench.py
                bench[q5]: maxhops 1, 594 parameters, d 1,024) at 40 circuits
                of its recipe and at 1,000 four times deeper: bulk
                probabilities cold and warm, against the CPU path and a
                numpy product of Kronecker-embedded leaves, data without
                zero counts, the sparse layout, ModelTest
 16. cloudfit -- create_cloudnoise_circuits for 2 qubits on the card, a
                cloud-noise fit from zero (chi2, then logL) on 1000 shots of
                a truth with an idle H_X of 0.03: the kernel at this
                layout's bucket shapes (K1 11, three parallel layers), Tv
                against jacfwd, the planted rate, its own launch count
 17. statevec -- phase 15's circuits on a 5-qubit model of static unitaries:
                state vectors against superoperators on the card
 18. q3rb    -- the JAX package's 3-qubit cell (bench.py bench[q3]: 60
                direct-RB circuits from RandomState(2026), bulk probabilities
                of a depolarized crosstalk-free model cold and warm) against
                the CPU path, the noiseless model and the stabilizer
                simulator; then a 240-circuit DirectRBDesign to depth 128,
                1,000 shots simulated on the card, RandomizedBenchmarking
                with 200 bootstraps against the exact decay
 19. crb2    -- 2-qubit Clifford RB (240 circuits to 64 Cliffords) simulated
                on the card and fitted as in 18; mirror-RB circuits of one
                depth back to their ideal outcomes
 20. cloudfit3 -- phase 16 at 3 qubits (534 parameters, d 64, eight
                outcomes): the op stack beyond a block's shared memory, so
                the kernel's two-stage route; the kernel at this layout's
                buckets (bitwise between launches, each stage's time), Tv
                against jacfwd, the fit, its own launch count (the buckets
                times the LM iterations); the card's design at maxL 2
                against the CPU path's count
 21. statistics -- phase 3's 'full' estimate: the Gauss-Newton Hessian
                through the kernel (against its plain version and finite
                differences), the exact Hessian (symmetry, finite
                differences, time, peak memory), the non-gauge dimension,
                the four projections, 95% error bars of two gates'
                infidelities from both Hessians, a linear-response error
                bar; a fit of data that drift between two over-rotations
                through GateSetTomography.run with the bad-fit actions
                'wildcard1d', 'wildcard' and 'Robust+' (N_sigma above 2, the
                budgets at their thresholds, the water-fill card against
                CPU); the Fisher information by L; its own launch count
 22. data io -- phase 3's dataset written to a text file and read back
                (with and without the zero counts); run_long_sequence_gst from
                the file with its defaults (LGST start, 'stdgaugeopt') against
                phase 3's optimum, with its own launch count; its results
                written to a directory and read back bit for bit; the
                empty-data workflow (a template filled with counts drawn on
                the card); 4 bootstrap refits of resamples through the
                kernel, gauge-optimized, their spread of Gxpi2:0's
                infidelity against phase 21's Hessian error bar; its own
                launch count
 23. design selection -- smq2Q_XYICNOT 'full' at full width (1,616
                parameters, 6 ops): find_fiducials with its defaults (781
                candidates) on the card, both sets spanning d^2 = 16;
                find_germs with its defaults (greedy, 'allJac', the pool
                {3: 'all upto'}) on the card, the set complete for its pool
                and its score recomputed on the host's CPU; per-germ
                fiducial-pair reduction of the pack's fiducials and
                test_fiducial_pairs; the selected design to maxL 16 fitted by
                run_long_sequence_gst_base on 1,000 shots of phase 3's
                data-generating model, the kernel held at its buckets, its
                own launch count
 24. errgen propagation -- bench.py bench[q10] through the port: H/S error
                generators through a 10-qubit, 40-layer seeded random
                Clifford circuit, then their BCH combination at order 2,
                and the all-zeros outcome's probability polynomial
 25. mirror  -- 4 qubits: MCFE of six u3-cx circuits (widths 2-4, depths 4
                and 8; 180 mirror circuits simulated on the card), each
                estimate held to the circuit's exact process fidelity; a
                volumetric benchmark of 200 periodic mirror circuits
                (widths 1-4) simulated on the card, its polarizations, VB
                table and capability regions; op-less models' predictions
                and derivatives; the weak CHP simulator on bench[q3]
 26. term    -- smq2Q_XYICNOT 'H+s' (240 parameters) on phase 3's maxL-16
                list (8,740 circuits): the Taylor-term simulator's order-2
                coefficients built on the card, conservation, the dense
                simulator's probabilities, cubic convergence, dprobs
                against central differences, the card against the CPU
 27. time-resolved fit -- smq2Q_XYICNOT 'full TP' depolarized 0.01 whose
                Gxpi2:0 is a LinearTimeDriftOp (15 'H' rates, one planted:
                0.02 rad at the last of 10 timestamps); phase 3's 13,958
                circuits at 100 shots per timestamp drawn on the card; the
                fit from the drift-free target by SimplerLMOptimizer through
                TimeDependentPoissonPicLogLFunction (the kernel once per time
                and bucket), its own launch count; the fitted rates' norm,
                N_sigma, jtj_jtf card against CPU, the kernel at the fit's
                buckets with G(t = 9)
 28. drift   -- the same drift ramping to 0.2 rad over 1,000 single-shot
                timestamps of the maxL-4 list (3,527 circuits): StabilityAnalysis
                (spectra on the card), 'filter' and 'mle' characterization,
                DataComparator on the halves; the same on static data
 29. fogi    -- smq2Q_XYICNOT 'H+s' (240 parameters) with its FOGI
                decomposition (174 FOGI, 66 FOGV directions, set up on the
                host); a truth of planted FOGI components on phase 3's
                13,958 circuits at 1,000 shots drawn on the card, fitted
                through GateSetTomography.run (a) in FOGI coordinates (174
                parameters, the interposer in Tv) and (b) in the raw ones:
                (a) not below (b) and above it by no more than (b)'s 66
                extra FOGV parameters can take from the noise, (a) within 5
                Hessian sigma of the planted components;
                Tv card against CPU and jacfwd; the kernel at the fit's
                buckets; each fit's own launch count
 30. leakage -- create_3level_model of smq1Q_XYI 'full TP' (243
                parameters, d 9, two outcomes), a truth whose Gxpi2:0 leaks,
                the lite design at maxL 1..64 (793 circuits) drawn on the
                card, GateSetTomography.run, add_lago_models: probabilities
                kept, the element in U(2)+U(1), the leakage rate against the
                truth's in one frame; the kernel at this layout's buckets
                (d 9, NOUT 2); its own launch count
 31. report  -- phase 3's estimate, not refitted: per operation the
                entanglement, eigenvalue-entanglement, eigenvalue (Choi) and
                generator infidelities of the fitted, gauge-optimized and
                data-generating models, the first unmoved by the gauge and
                within 10% of the truth's; gate-set, POVM and Choi metrics;
                project_model's five projections evaluated on the full
                dataset on the card; LogLWildcardFunction over the final
                list's logL (w = 0 is the objective, larger budgets never
                raise it, the card against the CPU); check_jac of the
                kernel's chi2 Jacobian on the first list (907 circuits, 1,616
                parameters) within 1e-5 of max |J| at eps 1e-8 (1e-7 logged),
                its launches one per
                bucket, the kernel at those buckets against its plain version;
                CompressedCircuit, parallelize and convert_to_openqasm on
                every circuit of the design
 32. interp  -- smq2Q_XYICNOT 'static' whose four single-qubit gates are
                InterpolatedDenseOps over 21 x 21 grids of (rotation angle,
                axis tilt), 8 physical parameters; data of the same model at
                off-node points on phase 3's 13,958 circuits (1,000 shots,
                drawn on the card); the fit from the grid's midpoint through
                GateSetTomography.run (chi2 stages, then logL), every
                parameter within 5 Hessian sigma of the truth; Tv card
                against CPU and central differences; jtj_jtf card against
                CPU; the kernel at the fit's buckets; its own launch count
 33. idt + crosstalk -- ibmq_bogota's first 4 qubits (extras.devices, d
                256): idle tomography of a planted weight <= 2 'H+s' idle
                through SimpleRunner and do_idle_tomography at 100,000
                shots, every rate within 5 propagated standard errors of
                the exact probabilities' estimate; crosstalk detection of a
                planted 'XX' error of Gxpi2:Q1 on 600 random circuits, and
                none without it; both again through one TreeRunner
 34. lfh     -- the fluctuating-Hamiltonian simulators (integrating,
                sigma-point, weak) on smq2Q_XYICNOT 'H+s' over the maxL-4
                list: exact at deviation 0, integrating within 5 MC errors
                of weak, the sigma-point gap fourth order, card against CPU
 35. report  -- phase 3's results, not refitted, through
                construct_standard_report(results, confidence_level=95)
                .write_html, write_pdf and create_report_notebook: every
                section of the page, an error bar in every gate-metric cell
                but unitarity's and in every prep cell (the Gauss-Newton
                Hessian through the kernel, against its plain version; its
                own launch count), N_sigma, the box plot's per-circuit values
                against the final 2*DeltaLogL, the dependency-restricted
                error bar against every parameter differenced and phase 21's,
                the diamond norm's linearization against central differences
                of the maximization, the kernel at the Hessian's buckets.
                Phases 25, 28, 29 and 33 also write their reports (VB plots,
                drift, FOGI diagram, idle tomography) and find their own
                numbers in them
 36. simulator modes -- on phase 3's data and fitted point: the germ-power
                product cache of the final list (its counts those of the
                JAX package's plan), the factorized probabilities against
                the scan on every element, 'prodjac' against 'blocked' 1e-3
                off the fitted point and on the card against the CPU, a GST
                fit through 'prodjac' at phase 3's optimum without a launch
                of the kernel, exact Hessians of 4 circuits against central
                differences, and the mesh path on a one-rank NCCL group bit
                for bit the serial 'linearize' objective
Then a JSON line of kernel numbers, the card's name and power limit, and the
last line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.time()

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the float64 and
# float32 rates outside the tensor cores, which is where this kernel's
# multiply-adds run.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 33.5e12, torch.float32: 67e12}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
MAXL = 64
LM_MAXITER = 100     # the optimizer's default cap on every stage
MINCLIP = 1e-4


def log(*args):
    print(*args, flush=True)


def card_name_and_limit():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_and_host_ms(fn, reps):
    """(card ms, host ms) per run of fn() over `reps` runs after one warm-up.
    The stream first sleeps ~10 ms on the card, so every run is queued
    before the start event: the card's time leaves out the host's dispatch,
    which the host clock around the queueing gives instead."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def phase_build():
    from pygsti_tpu_torch.ops import build
    t0 = time.time()
    sources = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR) if f.endswith('.cu'))
    started = [build.start_build(name) for name in sources]   # all at once
    for name, job in zip(sources, started):
        out = build.finish_build(*job)
        log("build %s: %s" % (name, " | ".join(
            l.strip() for l in out.splitlines() if 'registers' in l or 'spill' in l)))
    for name in sources:
        build.load_library(name)
    log("build: %d source(s) in %.3f s" % (len(sources), time.time() - t0))


def einsum_yardstick(cols, G, E, F):
    """The same function as one batched einsum over the stashed
    back-propagated effects: a loop forms Bc before each layer, then
    A[b,n,k,i,j] = sum_t onehot[b,t,k] Bc[b,t,n,i] F[b,t,j] is one
    batched matrix product."""
    B, D = cols.shape
    K1 = G.shape[0]
    onehot = torch.nn.functional.one_hot(cols.long(), K1).to(G.dtype)   # [B,D,K1]
    Gsel = G[cols.long()]                                               # [B,D,d,d]
    stash = torch.empty((B, D) + tuple(E.shape[1:]), dtype=G.dtype, device=G.device)
    bc = E
    for t in range(D - 1, -1, -1):
        stash[:, t] = bc
        bc = torch.einsum('bni,bij->bnj', bc, Gsel[:, t])
    W = onehot[..., None] * F[:, :, None, :]                            # [B,D,K1,d]
    A = torch.einsum('btni,btkj->bnkij', stash, W)
    return A, bc


def phase_kernels(layout, model, device):
    """Every kernel against its plain version at the fit's shapes."""
    from pygsti_tpu_torch.objectivefns.objectivefns import bucket_plan
    from pygsti_tpu_torch.ops.bwd_jacobian import (bwd_jacobian_accumulate,
                                                   bwd_jacobian_accumulate_plain)
    n_out = 4
    K1, d = len(model.op_keys) + 1, model.dim
    NT = (K1 - 1) * d * d + d + n_out * d      # tensor entries: ops, prep, effects
    buckets, _ = bucket_plan(layout, n_out, NT, device)
    gen = torch.Generator(device='cpu').manual_seed(1234)
    G = torch.cat([model.tensors_fn()(torch.as_tensor(model.to_vector())).ops,
                   torch.eye(d, dtype=torch.float64)[None]]).to(device)
    def check(what, dtype, cols, A, Bf, A2, Bf2):
        """Max abs error of (A, Bf) against (A2, Bf2); fatal beyond tolerance."""
        err = max(float((A - A2).abs().max()), float((Bf - Bf2).abs().max()))
        scale = max(float(A2.abs().max()), float(Bf2.abs().max()))
        if not err <= TOL[dtype] * scale:
            raise SystemExit("kernel bwd_jacobian disagrees with its plain version (%s): "
                             "%s B=%d D=%d max_abs_err=%g (scale %g)"
                             % (what, dtype, *cols.shape, err, scale))
        return err, scale

    rows = {}
    for dtype in (torch.float64, torch.float32):
        tot = {'ms': 0.0, 'card_ms': 0.0, 'host_ms': 0.0, 'plain_ms': 0.0,
               'einsum_ms': 0.0, 'bytes': 0, 'flops': 0}
        max_rel, max_abs = 0.0, 0.0
        name = str(dtype).split('.')[-1]
        for bk in buckets:
            cols = bk['cols']
            B, D = cols.shape
            E = torch.randn((B, n_out, d), generator=gen, dtype=torch.float64).to(device, dtype)
            F = torch.randn((B, D, d), generator=gen, dtype=torch.float64).to(device, dtype)
            Gd = G.to(dtype)
            A, Bf = bwd_jacobian_accumulate(cols, Gd, E, F)
            A_again, Bf_again = bwd_jacobian_accumulate(cols, Gd, E, F)
            torch.cuda.synchronize()
            if not (torch.equal(A, A_again) and torch.equal(Bf, Bf_again)):
                raise SystemExit("kernel bwd_jacobian is not bitwise deterministic: "
                                 "%s B=%d D=%d" % (dtype, B, D))
            del A_again, Bf_again
            A2, Bf2 = bwd_jacobian_accumulate_plain(cols, Gd, E, F)
            err, scale = check('fit layers', dtype, cols, A, Bf, A2, Bf2)
            A3, _ = einsum_yardstick(cols, Gd, E, F)
            yard = float((A3 - A2).abs().max()) / scale
            if not yard <= 1e3 * TOL[dtype]:
                raise SystemExit("the einsum yardstick disagrees with the plain version: "
                                 "%s B=%d D=%d rel %g" % (dtype, B, D, yard))
            max_rel, max_abs = max(max_rel, err / scale), max(max_abs, err)
            del A2, Bf2, A3
            # op indices -1 and K1 select no op: 5% of the layers each
            r = torch.rand(cols.shape, generator=gen).to(device)
            bad = torch.where(r < 0.05, -1, torch.where(r < 0.10, K1, cols)).to(torch.int32)
            A, Bf = bwd_jacobian_accumulate(bad, Gd, E, F)
            A2, Bf2 = bwd_jacobian_accumulate_plain(bad, Gd, E, F)
            err_oob, _ = check('op indices out of range', dtype, bad, A, Bf, A2, Bf2)
            max_abs = max(max_abs, err_oob)
            del A, Bf, A2, Bf2, bad
            ms = cuda_time_ms(lambda: bwd_jacobian_accumulate(cols, Gd, E, F), 20)
            item = torch.finfo(dtype).bits // 8
            # each input read once, each output written once
            nbytes = (cols.numel() * 4 + (Gd.numel() + E.numel() + F.numel()) * item
                      + (B * n_out * K1 * d * d + B * n_out * d) * item)
            # per layer and pair: d*d multiply-adds into A, d*d into the new Bc
            flops = B * n_out * D * 2 * (2 * d * d)
            bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3
            card_ms, host_ms = card_and_host_ms(
                lambda: bwd_jacobian_accumulate(cols, Gd, E, F), 20)
            log("kernel bwd_jacobian %s bucket B=%d D=%d: %.4f ms, bound %.4f ms "
                "(%.1f%% of bound, %.1f MB); the card alone %.4f ms (%.1f%% of bound), "
                "host dispatch %.4f ms per call"
                % (name, B, D, ms, bound, 100 * bound / ms, nbytes / 1e6,
                   card_ms, 100 * bound / card_ms, host_ms))
            tot['ms'] += ms
            tot['card_ms'] += card_ms
            tot['host_ms'] += host_ms
            tot['plain_ms'] += cuda_time_ms(lambda: bwd_jacobian_accumulate_plain(cols, Gd, E, F), 2)
            tot['einsum_ms'] += cuda_time_ms(lambda: einsum_yardstick(cols, Gd, E, F), 2)
            tot['bytes'] += nbytes
            tot['flops'] += flops
        t_bytes = tot['bytes'] / PEAK_BYTES_PER_S * 1e3
        t_ops = tot['flops'] / PEAK_FLOPS[dtype] * 1e3
        rows[dtype] = dict(tot, max_rel=max_rel, max_abs=max_abs,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by='bytes' if t_bytes >= t_ops else 'operations')
        log("kernel bwd_jacobian %s: %d launches per Jacobian (blocks %s), max rel err "
            "%.3e (tol %.0e; also held on op indices out of range, and bitwise "
            "between two launches), kernel %.4f ms (%.1f%% of bound; the card alone "
            "%.4f ms, host dispatch %.4f ms), plain %.4f ms, einsum yardstick %.4f ms, "
            "bound %.4f ms (%s: %.1f MB, %.2f GFLOP)"
            % (name, len(buckets), [tuple(b['cols'].shape) for b in buckets], max_rel,
               TOL[dtype], tot['ms'], 100 * rows[dtype]['bound_ms'] / tot['ms'],
               tot['card_ms'], tot['host_ms'],
               tot['plain_ms'], tot['einsum_ms'], rows[dtype]['bound_ms'],
               rows[dtype]['bound_by'], tot['bytes'] / 1e6, tot['flops'] / 1e9))
    return rows


def reference_probs(model, circuits):
    """Plain numpy: p = E (G_L ... G_1 rho) circuit by circuit; a circuit
    with instruments once per combination of their members, in the
    layout's order; a parallel layer as the product of its components, the
    first applied first."""
    import itertools
    ops = {k: o.dense() for k, o in model.operations.items()}
    # a bare gate name that names one operation ('Gx' for 'Gx:T0') stands for it
    names = [k.name for k in model.operations]
    ops.update({k.name: o for k, o in list(ops.items())
                if k.name != k and names.count(k.name) == 1 and k.name not in ops})
    for c in circuits:
        for layer in c.layertup:
            if layer not in ops and len(layer.components) > 1 and \
                    all(comp in ops for comp in layer.components):
                mx = np.eye(model.dim)
                for comp in layer.components:
                    mx = ops[comp] @ mx
                ops[layer] = mx
    insts = {k: dict(zip(i.member_labels, i.dense())) for k, i in model.instruments.items()}
    rho = next(iter(model.preps.values())).dense()
    effects = next(iter(model.povms.values())).dense()
    out = []
    for c in circuits:
        at = [l for l in c.layertup if l in insts]
        for combo in itertools.product(*[list(insts[l]) for l in at]):
            members = iter(combo)
            s = rho
            for layer in c.layertup:
                s = (insts[layer][next(members)] if layer in insts else ops[layer]) @ s
            out.append(effects @ s)
    return np.concatenate(out)


def with_z_instrument(model, depol=0.0):
    """`model` with the TPInstrument 'Iz:0', a Z measurement of qubit 0:
    members rho -> (P_k x I) rho (P_k x I) in the pp basis, each
    left-multiplied by the depolarization diag(1, 1 - depol, ...), so that
    they still sum to a TP map."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.modelmembers.instruments import TPInstrument
    from pygsti_tpu_torch.tools.basistools import change_basis
    members = {}
    for k in (0, 1):
        P = np.kron(np.diag([1.0 - k, float(k)]), np.eye(2))
        mx = np.real(change_basis(np.kron(P, P.conj()), 'std', 'pp'))
        members['p%d' % k] = np.diag([1.0] + [1.0 - depol] * 15) @ mx
    model.instruments[Label('Iz', 0)] = TPInstrument(members)
    return model


def log_stages(prefix, est, lists):
    """Print each LM stage of an estimate; returns the total of iterations."""
    total_iters = 0
    for i, stage_results in enumerate(est.parameters['optimizer_results']):
        for r in stage_results:
            q = r.optimizer_specific_qtys
            total_iters += q['iterations']
            log("%s stage %d (%d circuits) %s: %d LM iterations, %.3f s, objective %.6f, %s"
                % (prefix, i, len(lists[i]), r.objective.name, q['iterations'], q['wall_s'],
                   r.f, q['msg']))
    return total_iters


def phase_cptp_fit(mp, lists, ds, builders, full_value, full_model, check, device):
    """The CPTPLND fit at full width; returns its kernel launch count."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyCheckpoint,
                                                GateSetTomographyDesign, GSTInitialModel)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    from pygsti_tpu_torch.tools.jamiolkowski import fast_jamiolkowski_iso_std

    t0 = time.time()
    target = mp.target_model('CPTPLND')
    log("cptp: target model of %d parameters, members %s, built in %.2f s"
        % (target.num_params,
           sorted({type(o).__name__ for _, o in target._iter_parameterized_objs()}),
           time.time() - t0))
    if target.num_params != 1920:
        raise SystemExit("unexpected CPTPLND model size")
    data = ProtocolData(GateSetTomographyDesign(target, lists), ds)
    gst = GateSetTomography(GSTInitialModel(target_model=target, starting_point='target'),
                            gaugeopt_suite=None, objfn_builders=builders,
                            optimizer={'maxiter': LM_MAXITER}, verbosity=0, device=device)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bwd_jacobian_accumulate.launches = 0
    with tempfile.TemporaryDirectory() as ckdir:
        t0 = time.time()
        results = gst.run(data, checkpoint_path=os.path.join(ckdir, 'cptp'))
        torch.cuda.synchronize()
        run_wall = time.time() - t0
        launches = bwd_jacobian_accumulate.launches
        ckfiles = sorted(os.listdir(ckdir))
        cksizes = [os.path.getsize(os.path.join(ckdir, f)) for f in ckfiles]
        last_ck = GateSetTomographyCheckpoint.read(
            os.path.join(ckdir, 'cptp_iteration_%d.json' % (len(lists) - 1)))
    est = results.estimates['GateSetTomography']
    timers = est.parameters['profiler']
    total_iters = log_stages('cptp', est, lists)
    fit_wall = est.parameters['fit_time'] - timers['checkpoint writes']
    value = est.parameters['final_objfn_value']
    dof = est.parameters['final_dof']
    nsigma = est.misfit_sigma()
    log("cptp: %d LM iterations in %.3f s wall, %.1f ms per iteration "
        "(GateSetTomography.run as a whole: %.3f s); final 2*DeltaLogL %.6f "
        "(the 'full' fit: %.6f), k %d, N_sigma %.4f"
        % (total_iters, fit_wall, 1e3 * fit_wall / max(total_iters, 1), run_wall, value,
           full_value, dof, nsigma))
    log("cptp: kernel launches {'bwd_jacobian': %d}; peak device memory %.1f MB; "
        "checkpoints: %d files, %s bytes"
        % (launches, torch.cuda.max_memory_allocated() / 1e6, len(ckfiles), cksizes))
    fitted = est.models['final iteration estimate']
    theta = fitted.to_vector()
    if launches == 0:
        raise SystemExit("the CPTPLND fit never launched the bwd_jacobian kernel")
    if not (np.all(np.isfinite(theta)) and np.isfinite(value) and np.isfinite(nsigma)):
        raise SystemExit("non-finite CPTPLND fit result")
    if not nsigma < 10:
        raise SystemExit("the CPTPLND fit is far from the statistical optimum: N_sigma %g"
                         % nsigma)
    # the CPTPLND family lies inside the 'full' family up to gauge
    if value < full_value * (1 - 1e-6):
        raise SystemExit("the CPTPLND fit (%.6f) is below the 'full' fit (%.6f)"
                         % (value, full_value))
    min_eval, tp_dev = np.inf, 0.0
    for lbl, op in fitted.operations.items():
        mx = op.dense()
        choi = fast_jamiolkowski_iso_std(mx, fitted.basis)
        min_eval = min(min_eval, float(np.linalg.eigvalsh((choi + choi.conj().T) / 2).min()))
        tp_dev = max(tp_dev, float(np.max(np.abs(mx[0] - np.eye(fitted.dim)[0]))))
    log("cptp: fitted operations: least Choi eigenvalue %.3e (tol -1e-9), first row off e0 "
        "by at most %.3e (tol 1e-9)" % (min_eval, tp_dev))
    if not (min_eval >= -1e-9 and tp_dev <= 1e-9):
        raise SystemExit("a fitted CPTPLND operation is not CPTP")
    check_layout = SimpleForwardSimulator(fitted, device).create_layout(check)
    p_card = SimpleForwardSimulator(fitted, device).bulk_fill_probs(None, check_layout)
    p_ref = reference_probs(fitted, check)
    dp = float(np.max(np.abs(p_card - p_ref)))
    log("cptp: probabilities of %d circuits vs numpy reference: max |dp| %.3e (tol 1e-10)"
        % (len(check), dp))
    if p_card.shape != p_ref.shape or not dp < 1e-10:
        raise SystemExit("CPTPLND probabilities disagree with the numpy reference")
    if len(ckfiles) != len(lists) or \
            not np.array_equal(last_ck.mdl_list[-1].to_vector(), theta):
        raise SystemExit("the last CPTPLND checkpoint does not read back to the final model")

    # what the parameterization costs: the model's tensors and their Jacobian
    # Tv = d tensors / d theta, once per LM iteration; Tv as the objective
    # takes it (as many tangents as the largest member has parameters)
    # beside plain forward mode over all P tangents
    per_iter_ms = 1e3 * fit_wall / max(total_iters, 1)
    for name, model in (('CPTPLND', fitted), ('full', full_model)):
        flat, jac = model.flat_tensors_fn(), model.flat_tensors_jacobian_fn()
        v = torch.as_tensor(model.to_vector(), device=device)

        def tensors_and_tv():
            flat(v)
            return jac(v)

        def tensors_and_tv_all_tangents():
            flat(v)
            return torch.func.jacfwd(flat)(v)
        Tv = tensors_and_tv()
        dtv = float((Tv.cpu() - jac(v.cpu())).abs().max())
        dall = float((Tv - tensors_and_tv_all_tangents()).abs().max())
        ms = cuda_time_ms(tensors_and_tv, 20)
        card_ms, host_ms = card_and_host_ms(tensors_and_tv, 20)
        all_ms = cuda_time_ms(tensors_and_tv_all_tangents, 20)
        all_card_ms, all_host_ms = card_and_host_ms(tensors_and_tv_all_tangents, 20)
        log("cptp: tensors_fn + Tv of the %s model (%d parameters, Tv %s): %.3f ms "
            "(the card alone %.3f ms, host dispatch %.3f ms)%s; with all %d tangents "
            "%.3f ms (the card alone %.3f ms, host dispatch %.3f ms), max |diff| %.3e; "
            "Tv on the card vs the CPU max |diff| %.3e (tol 1e-10)"
            % (name, model.num_params, tuple(Tv.shape), ms, card_ms, host_ms,
               ", %.1f%% of the %.1f ms of one LM iteration of this fit"
               % (100 * ms / per_iter_ms, per_iter_ms) if name == 'CPTPLND' else "",
               model.num_params, all_ms, all_card_ms, all_host_ms, dall, dtv))
        if not (dtv < 1e-10 and dall < 1e-10):
            raise SystemExit("Tv of the %s model on the card disagrees with the CPU or "
                             "with plain forward mode" % name)
    # the library's matrix exponential in the band of norms where error
    # generators of a near-target model lie, beside the port's shifted form
    import scipy.linalg
    from pygsti_tpu_torch.modelmembers.operations import _matrix_exp
    a = np.random.RandomState(0).randn(16, 16)
    a *= 0.045 / np.linalg.norm(a, 1)
    at, ref = torch.as_tensor(a, device=device), scipy.linalg.expm(a)
    err_lib = float(np.max(np.abs(torch.linalg.matrix_exp(at).cpu().numpy() - ref)))
    err_own = float(np.max(np.abs(_matrix_exp(at).cpu().numpy() - ref)))
    log("cptp: matrix exponential of a 16x16 float64 matrix of 1-norm 0.045 on the card vs "
        "scipy: torch.linalg.matrix_exp max |diff| %.3e, the port's exp(A + I) / e %.3e "
        "(tol 1e-13)" % (err_lib, err_own))
    if not err_own < 1e-13:
        raise SystemExit("the port's matrix exponential disagrees with scipy on the card")
    return launches


def phase_instrument_fit(mp, lists, datagen, builders, device):
    """The 2-qubit fit with a mid-circuit measurement at full width; returns
    its kernel launch count."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.circuits.circuit import Circuit
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyCheckpoint,
                                                GateSetTomographyDesign, GSTInitialModel)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData

    target = with_z_instrument(mp.target_model('full'))
    gen = with_z_instrument(datagen.copy(), depol=0.01)
    iz = Circuit([Label('Iz', 0)], line_labels=(0, 1))
    extra = [p + iz * k + m for k in (1, 2) for p in mp.prep_fiducials()
             for m in mp.meas_fiducials()]
    # the instrument circuits first, so that every list is a prefix of the
    # last and the stages share one layout
    ilists = [extra + list(l) for l in lists]
    final = ilists[-1]
    layout = SimpleForwardSimulator(target, device).create_layout(final)
    log("instrument: %d circuits (%d with Iz:0), %d rows, %d elements, %d parameters, "
        "op stack K1 = %d"
        % (len(final), len(extra), layout.num_rows, layout.num_elements, target.num_params,
           len(target.op_keys) + 1))
    if (len(final), layout.num_rows, layout.num_elements, target.num_params) != \
            (14310, 15014, 60056, 2112):
        raise SystemExit("unexpected instrument design size")
    t0 = time.time()
    ds = simulate_data(gen, final, 1000, seed=1234, device=device)
    log("instrument: data simulated on the card in %.2f s" % (time.time() - t0))
    data = ProtocolData(GateSetTomographyDesign(target, ilists), ds)
    gst = GateSetTomography(GSTInitialModel(target_model=target, starting_point='target'),
                            gaugeopt_suite=None, objfn_builders=builders,
                            optimizer={'maxiter': LM_MAXITER}, verbosity=0, device=device)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bwd_jacobian_accumulate.launches = 0
    with tempfile.TemporaryDirectory() as ckdir:
        t0 = time.time()
        results = gst.run(data, checkpoint_path=os.path.join(ckdir, 'inst'))
        torch.cuda.synchronize()
        run_wall = time.time() - t0
        launches = bwd_jacobian_accumulate.launches
        ckfiles = sorted(os.listdir(ckdir))
        cksizes = [os.path.getsize(os.path.join(ckdir, f)) for f in ckfiles]
        last_ck = GateSetTomographyCheckpoint.read(
            os.path.join(ckdir, 'inst_iteration_%d.json' % (len(ilists) - 1)))
    est = results.estimates['GateSetTomography']
    total_iters = log_stages('instrument', est, ilists)
    fit_wall = est.parameters['fit_time'] - est.parameters['profiler']['checkpoint writes']
    value, nsigma = est.parameters['final_objfn_value'], est.misfit_sigma()
    log("instrument: %d LM iterations in %.3f s wall, %.1f ms per iteration "
        "(GateSetTomography.run as a whole: %.3f s); final 2*DeltaLogL %.6f, k %d, "
        "N_sigma %.4f" % (total_iters, fit_wall, 1e3 * fit_wall / max(total_iters, 1),
                          run_wall, value, est.parameters['final_dof'], nsigma))
    log("instrument: kernel launches {'bwd_jacobian': %d}; peak device memory %.1f MB; "
        "checkpoints: %d files, %s bytes"
        % (launches, torch.cuda.max_memory_allocated() / 1e6, len(ckfiles), cksizes))
    fitted = est.models['final iteration estimate']
    theta = fitted.to_vector()
    if launches == 0:
        raise SystemExit("the instrument fit never launched the bwd_jacobian kernel")
    if not (np.all(np.isfinite(theta)) and np.isfinite(value) and nsigma < 10):
        raise SystemExit("the instrument fit is not finite or far from the statistical "
                         "optimum: N_sigma %g" % nsigma)
    members = fitted.instruments[Label('Iz', 0)].dense()
    tp_dev = float(np.max(np.abs(members.sum(axis=0)[0] - np.eye(fitted.dim)[0])))
    log("instrument: the fitted members sum to a map whose first row is off e0 by %.3e "
        "(tol 1e-9)" % tp_dev)
    if not tp_dev <= 1e-9:
        raise SystemExit("the fitted instrument is not trace-preserving")
    check = final[:100] + final[len(extra)::(len(final) - len(extra)) // 100][:100]
    sim = SimpleForwardSimulator(fitted, device)
    p_card = sim.bulk_fill_probs(None, sim.create_layout(check))
    p_ref = reference_probs(fitted, check)
    dp = float(np.max(np.abs(p_card - p_ref)))
    log("instrument: probabilities of %d circuits (100 with Iz:0) vs a numpy reference that "
        "expands the members: max |dp| %.3e (tol 1e-10)" % (len(check), dp))
    if p_card.shape != p_ref.shape or not dp < 1e-10:
        raise SystemExit("instrument probabilities disagree with the numpy reference")
    back = last_ck.mdl_list[-1]
    if len(ckfiles) != len(ilists) or list(back.instruments) != [Label('Iz', 0)] or \
            not np.array_equal(back.to_vector(), theta):
        raise SystemExit("the last instrument checkpoint does not read back to the final "
                         "model with its instrument")
    objs = [ObjectiveFunctionBuilder('logl').build(fitted, ds, ilists[0], device=dev)
            for dev in (device, 'cpu')]
    rel = card_vs_cpu(objs, theta)
    log("instrument: blocked lsvec/JTJ/JTf (mode %s) on the card vs the CPU path (%d "
        "circuits): max rel diff %.3e (tol 1e-9)" % (objs[0].jac_mode, len(ilists[0]), rel))
    if objs[0].jac_mode != 'blocked' or not rel < 1e-9:
        raise SystemExit("the instrument objective on the card disagrees with the CPU path: "
                         "max rel diff %.3e" % rel)
    return launches


def card_vs_cpu(objs, theta):
    """Largest relative difference of lsvec, J^T J and J^T f between the
    objectives objs = (on the card, on the CPU) at theta."""
    (ls_c, jtj_c, jtf_c), (ls_h, jtj_h, jtf_h) = (o.jtj_jtf(theta) for o in objs)
    return max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
               for a, b in ((ls_c, ls_h), (jtj_c, jtj_h), (jtf_c, jtf_h)))


def phase_sparse(datagen, fitted, ds, lists, device):
    """Sparse observed-outcome layouts and the forward-mode Jacobian on
    phase 3's data and on 40 shots of the same circuits (where many
    outcomes go unobserved, as in the JAX package's test), then the
    penalty rows."""
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder

    final, first = list(lists[-1]), list(lists[0])
    theta, th_fit = datagen.to_vector(), fitted.to_vector()
    sim = SimpleForwardSimulator(datagen, device)
    linear = {'min_prob_clip': MINCLIP, 'radius': 1e-9}    # the linear zero-freq regime
    regs = {'min_prob_clip': MINCLIP, 'radius': MINCLIP}
    for shots, data in ((1000, ds), (40, simulate_data(datagen, final, 40, seed=7,
                                                       device=device))):
        tag = "sparse %d shots:" % shots
        dense_lay = sim.create_layout(final, data, observed_outcomes_only=False)
        sparse_lay = sim.create_layout(final, data, observed_outcomes_only=True)
        dense, sparse = (ObjectiveFunctionBuilder('logl', regularization=linear).build(
            datagen, data, final, device=device, layout=lay) for lay in (dense_lay, sparse_lay))
        log("%s %d circuits, %d elements dense, %d observed (%.1f%%); %d circuits with "
            "omitted outcomes; Jacobian modes: dense %s, sparse %s"
            % (tag, len(final), dense_lay.num_elements, sparse_lay.num_elements,
               100 * sparse_lay.num_elements / dense_lay.num_elements,
               len(sparse_lay.omitted_circuits), dense.jac_mode, sparse.jac_mode))
        if (dense.jac_mode, sparse.jac_mode) != ('blocked', 'linearize') or \
                not sparse_lay.has_omitted:
            raise SystemExit("unexpected sparse layout or Jacobian modes")
        fd, fs = dense.fn(theta), sparse.fn(theta)
        nd = float(np.sum(dense.lsvec(theta) ** 2))
        ns = float(np.sum(sparse.lsvec(theta) ** 2))
        _, jtj_d, jtf_d = dense.jtj_jtf(theta)
        _, jtj_s, jtf_s = sparse.jtj_jtf(theta)
        rel_jtf = float(np.max(np.abs(jtf_s - jtf_d)) / np.max(np.abs(jtf_d)))
        sym = float(np.max(np.abs(jtj_s - jtj_s.T)))
        log("%s at the data-generating point, radius 1e-9: fn sparse vs dense rel diff %.3e, "
            "|lsvec|^2 %.3e (tol 1e-12); JTf %.3e of its largest entry (tol 1e-9); JTJ finite "
            "%s, max |JTJ - JTJ^T| %.3e" % (tag, abs(fs - fd) / fd, abs(ns - nd) / nd, rel_jtf,
                                            bool(np.all(np.isfinite(jtj_s))), sym))
        if not (abs(fs - fd) <= 1e-12 * fd and abs(ns - nd) <= 1e-12 * nd and rel_jtf < 1e-9
                and np.all(np.isfinite(jtj_s)) and sym <= 1e-8 * np.max(np.abs(jtj_s))):
            raise SystemExit("the sparse objective disagrees with the dense one")
        # the cost of one J^T J / J^T f of each Jacobian at full width
        v = torch.as_tensor(theta, device=device)
        for name, obj, reps in (('linearize', sparse, 1), ('blocked', dense, 5)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_time_ms(lambda: obj._fns['jtj_jtf'](v, *obj._args()), reps)
            log("%s one jtj_jtf, %s Jacobian, %d elements, %d parameters: %.2f ms on the "
                "card, peak device memory %.1f MB" % (tag, name, obj.num_elements, len(theta),
                                                      ms, torch.cuda.max_memory_allocated() / 1e6))
        # the forward-mode Jacobian on the card against the CPU, on the first list
        objs = [ObjectiveFunctionBuilder('logl').build(
            fitted, data, first, device=dev, layout=SimpleForwardSimulator(fitted, dev)
            .create_layout(first, data, observed_outcomes_only=True)) for dev in (device, 'cpu')]
        rel = card_vs_cpu(objs, th_fit)
        log("%s 'linearize' lsvec/JTJ/JTf on the card vs the CPU path (%d circuits, %d "
            "elements, %d with omitted outcomes): max rel diff %.3e (tol 1e-9)"
            % (tag, len(first), objs[0].num_elements, len(objs[0].layout.omitted_circuits), rel))
        if not rel < 1e-9:
            raise SystemExit("the forward-mode Jacobian on the card disagrees with the CPU: "
                             "max rel diff %.3e" % rel)
        # a short LM fit on the sparse objective from a dense optimum.  The
        # 'full' fit's optimum is not one to start from: a 'full' model is
        # not TP, its probabilities of a circuit sum to 1 only within about
        # 1e-2, so a circuit's omitted mass 1 - (sum of its observed p) can
        # be negative, where the zero-frequency term is steep (at maxL 1,
        # 1000 shots, on the CPU, one such circuit's terms are 149 against
        # 3.7 in the dense objective).  So, as the JAX package's test does,
        # the fit is of the 'full TP' model: dense LM from the
        # data-generating point to its optimum, then LM on the sparse
        # objective from there.
        f_full = [ObjectiveFunctionBuilder('logl', regularization=regs).build(
            fitted, data, final, device=device, layout=lay).fn(th_fit)
            for lay in (dense_lay, sparse_lay)]
        log("%s at the 'full' fit's optimum (default radius) the dense objective is %.6f, "
            "the sparse one %.6f" % ((tag,) + tuple(f_full)))
        tp_dense, tp_sparse = (ObjectiveFunctionBuilder('logl', regularization=regs).build(
            datagen, data, final, device=device, layout=lay) for lay in (dense_lay, sparse_lay))
        t0 = time.time()
        x_d, _, _, _, _, _, _, iters_d = tp_dense.run_device_lm(theta, maxiter=LM_MAXITER)
        dense_s = time.time() - t0
        x_d = np.asarray(x_d)
        f0 = tp_sparse.fn(x_d)
        t0 = time.time()
        x, _, msg, _, _, _, _, iters = tp_sparse.run_device_lm(x_d, maxiter=10)
        lm_s = time.time() - t0
        f1 = tp_sparse.fn(np.asarray(x))
        log("%s 'full TP' LM, dense (blocked) from the data-generating point: %d iterations "
            "in %.3f s, objective %.6f; then sparse ('linearize') from there: %d iterations "
            "in %.3f s (%s), sparse objective %.6f -> %.6f (rel change %.3e, tol 2e-2)"
            % (tag, iters_d, dense_s, tp_dense.fn(x_d), iters, lm_s, msg, f0, f1,
               (f0 - f1) / f0))
        if not (np.isfinite(f1) and f1 <= f0 and (f0 - f1) <= 2e-2 * f0):
            raise SystemExit("the sparse LM fit rose or left the dense optimum")
    rows, depth = sparse_lay.op_indices.shape
    P, K1, d = len(theta), len(datagen.op_keys) + 1, datagen.dim
    log("sparse: forward mode at full width, per jtj_jtf: a plain vmap of jvp would gather "
        "%.3f TB of op tangents (P x B x d x d x 8 B per layer, read once: %.1f ms at "
        "%.2f TB/s); this one writes %.3f TB of dG s (K1 x B x d x P x 8 B per layer, %.1f ms)"
        % (P * rows * d * d * 8 * depth / 1e12,
           1e3 * P * rows * d * d * 8 * depth / PEAK_BYTES_PER_S, PEAK_BYTES_PER_S / 1e12,
           K1 * rows * d * P * 8 * depth / 1e12,
           1e3 * K1 * rows * d * P * 8 * depth / PEAK_BYTES_PER_S))
    # the penalty rows on the card against the CPU
    pens = {'cptp_penalty_factor': 1.0, 'spam_penalty_factor': 1.0}
    objs = [ObjectiveFunctionBuilder('logl', penalties=pens).build(fitted, ds, first, device=dev)
            for dev in (device, 'cpu')]
    rel = card_vs_cpu(objs, th_fit)
    log("sparse: jtj_jtf with CPTP and SPAM penalties (%d rows) on the card vs the CPU "
        "(%d circuits): max rel diff %.3e (tol 1e-9)"
        % (len(objs[0].lsvec(th_fit)) - objs[0].num_elements, len(first), rel))
    if not rel < 1e-9:
        raise SystemExit("the penalty rows on the card disagree with the CPU path: max rel "
                         "diff %.3e" % rel)


# Run in a fresh process by stage_split_ms: torch.profiler drops device
# events outside its capture window, and on the card's machine its clocks
# drift apart within minutes of a process's life, so a session of a few ms
# deep in this script records no kernel at all.
STAGE_SPLIT_CHILD = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
G, cases = torch.load(sys.argv[2])
G = G.cuda()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
out = []
for cols, E, F in cases:
    args = (cols.cuda(), G, E.cuda(), F.cuda())
    bwd_jacobian_accumulate(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            bwd_jacobian_accumulate(*args)
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = e.key.split('<')[0].split('::')[-1]
            ms[name] = ms.get(name, 0.0) + e.self_device_time_total / 3e3
    out.append(ms)
print(json.dumps(out))
"""


def stage_split_ms(G, cases):
    """Device ms per kernel launched by one call of the kernel's wrapper on
    each case (cols, E, F) with op stack G, profiled in a fresh process on
    the same card: [{kernel name: ms}, ...]."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'cases.pt')
        torch.save((G.cpu(), [tuple(t.cpu() for t in c) for c in cases]), path)
        run = subprocess.run([sys.executable, '-c', STAGE_SPLIT_CHILD, HERE, path],
                             capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise SystemExit("the stage profile's process failed:\n%s" % run.stderr[-3000:])
    return json.loads(run.stdout.strip().splitlines()[-1])


def hold_kernel_at_buckets(layout, model, device, prefix, at_time=None, stages=None):
    """The kernel against its plain version at every bucket shape of
    `layout` on the model's own op stack (at `at_time`, for a model with
    time-dependent members) and random E and F, f64 and f32, and bitwise
    between two launches, one line per shape with its route (and, on the
    two-stage route, the card's fill of A and each stage's device time,
    profiled in a fresh process, summed into `stages` where given); returns ({dtype: max relative error}, and f64 ms per Jacobian of
    the kernel, of the plain version, of the einsum yardstick, the least
    time the card could take for the same work, and the bucket shapes)."""
    from pygsti_tpu_torch.objectivefns.objectivefns import bucket_plan
    from pygsti_tpu_torch.ops.bwd_jacobian import (bwd_jacobian_accumulate,
                                                   bwd_jacobian_accumulate_plain,
                                                   g_in_shared_memory)
    n_out, d = layout.num_elements // layout.num_rows, model.dim
    K1 = len(model.op_keys) + 1
    # an explicit model's composite slots follow its operations; an implicit
    # model's layers are all slots alike
    n_composite = len(model.op_keys) - len(model.operations) \
        if hasattr(model, 'operations') else 0
    NT = (K1 - 1) * d * d + d + n_out * d
    buckets, _ = bucket_plan(layout, n_out, NT, device)
    gen = torch.Generator(device='cpu').manual_seed(99)
    v = torch.as_tensor(model.to_vector())
    ten = model.tensors_fn()(v) if at_time is None else model.tensors_fn_t()(v, at_time)
    G64 = torch.cat([ten.ops, torch.eye(d, dtype=torch.float64)[None]]).to(device)
    errs, ms, plain_ms, einsum_ms, bound_ms = {}, 0.0, 0.0, 0.0, 0.0
    split_cases = []            # f64 (cols, E, F) of the two-stage route's buckets
    for dtype in (torch.float64, torch.float32):
        G = G64.to(dtype)
        for bk in buckets:
            cols = bk['cols']
            B, D = cols.shape
            E = torch.randn((B, n_out, d), generator=gen, dtype=torch.float64).to(device, dtype)
            F = torch.randn((B, D, d), generator=gen, dtype=torch.float64).to(device, dtype)
            A, Bf = bwd_jacobian_accumulate(cols, G, E, F)
            A_again, Bf_again = bwd_jacobian_accumulate(cols, G, E, F)
            torch.cuda.synchronize()
            if not (torch.equal(A, A_again) and torch.equal(Bf, Bf_again)):
                raise SystemExit("kernel bwd_jacobian is not bitwise deterministic at a bucket "
                                 "of the %s layout: %s B=%d D=%d" % (prefix, dtype, B, D))
            del A_again, Bf_again
            A2, Bf2 = bwd_jacobian_accumulate_plain(cols, G, E, F)
            err = max(float((A - A2).abs().max()), float((Bf - Bf2).abs().max()))
            scale = max(float(A2.abs().max()), float(Bf2.abs().max()))
            if not err <= TOL[dtype] * scale:
                raise SystemExit("kernel bwd_jacobian disagrees with its plain version at a "
                                 "bucket of the %s layout: %s B=%d D=%d d=%d NOUT=%d K1=%d "
                                 "rel %g" % (prefix, dtype, B, D, d, n_out, K1, err / scale))
            if n_composite and not float(
                    A[:, :, len(model.operations):K1 - 1].abs().max()) > 0:
                raise SystemExit("no gradient block reached the composite layers' slots")
            errs[dtype] = max(errs.get(dtype, 0.0), err / scale)
            if dtype == torch.float64:
                k_ms = cuda_time_ms(lambda: bwd_jacobian_accumulate(cols, G, E, F), 5)
                p_ms = cuda_time_ms(lambda: bwd_jacobian_accumulate_plain(cols, G, E, F), 1)
                e_ms = cuda_time_ms(lambda: einsum_yardstick(cols, G, E, F), 1)
                # as in phase 2: each input read once, each output written once
                nbytes = cols.numel() * 4 + (G.numel() + E.numel() + F.numel()
                                             + B * n_out * K1 * d * d + B * n_out * d) * 8
                flops = B * n_out * D * 2 * (2 * d * d)
                b_ms = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3
                shared = g_in_shared_memory(G, n_out)
                split = ''
                if not shared:
                    split_cases.append((cols, E, F))
                    # the card's own fill of A's bytes: the store rate to beat
                    fill = cuda_time_ms(lambda: A.zero_(), 5)
                    split = " (A.zero_() %.4f ms)" % fill
                    if stages is not None:
                        stages['fill'] = stages.get('fill', 0.0) + fill
                log("%s: kernel bwd_jacobian float64 bucket B=%d D=%d (d %d, NOUT %d, K1 %d), "
                    "%s route: %.4f ms%s, bound %.4f ms (%.1f%% of it, %.1f MB), plain %.3f ms, "
                    "einsum yardstick %.3f ms, rel err %.3e"
                    % (prefix, B, D, d, n_out, K1, 'shared' if shared else 'two-stage', k_ms,
                       split, b_ms, 100 * b_ms / k_ms, nbytes / 1e6, p_ms, e_ms, err / scale))
                ms, plain_ms, einsum_ms, bound_ms = (ms + k_ms, plain_ms + p_ms,
                                                     einsum_ms + e_ms, bound_ms + b_ms)
            del A, Bf, A2, Bf2
    if split_cases:
        for (cols, _, _), by_kernel in zip(split_cases, stage_split_ms(G64, split_cases)):
            chain = sum(v for n, v in by_kernel.items() if 'chain' in n)
            tiles = sum(v for n, v in by_kernel.items() if 'tile' in n)
            log("%s: kernel bwd_jacobian float64 bucket B=%d D=%d, two-stage route, profiled "
                "in a fresh process: chain %.4f ms, tiles %.4f ms"
                % (prefix, *cols.shape, chain, tiles))
            if stages is not None:
                stages['chain'] = stages.get('chain', 0.0) + chain
                stages['tiles'] = stages.get('tiles', 0.0) + tiles
    return errs, ms, plain_ms, einsum_ms, bound_ms, [tuple(b['cols'].shape) for b in buckets]


def fit_launches(gst, data, prefix, lists):
    """GateSetTomography.run with the kernel's count set to 0 just before it
    and read just after; returns (estimate, launches, fit seconds, LM
    iterations, peak device MB)."""
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bwd_jacobian_accumulate.launches = 0
    results = gst.run(data, disable_checkpointing=True)
    torch.cuda.synchronize()
    launches = bwd_jacobian_accumulate.launches
    peak = torch.cuda.max_memory_allocated() / 1e6
    est = results.estimates['GateSetTomography']
    iters = log_stages(prefix, est, lists)
    return est, launches, est.parameters['fit_time'], iters, peak


def phase_parallel_fit(builders, device):
    """Phase 10: smq2Q_XXYYII, whose parallel layers are composite slots of
    the op stack, at full width and depth; returns (launches, kernel rel
    errors)."""
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.modelpacks import smq2Q_XXYYII as xp
    from pygsti_tpu_torch.models.gaugegroup import FullGaugeGroup
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                GSTInitialModel)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData

    t0 = time.time()
    target = xp.target_model('full')
    lists = create_lsgst_circuit_lists(target, xp.prep_fiducials(), xp.meas_fiducials(),
                                       xp.germs(), [1, 2, 4, 8, 16, 32, 64])
    final = list(lists[-1])
    layout = SimpleForwardSimulator(target, device).create_layout(final)
    K1 = len(target.op_keys) + 1
    depth = max(c.depth for c in final)
    log("parallel: smq2Q_XXYYII, %d lists, final list %d circuits, depth %d, %d parameters, "
        "%d operations + composite layers %s, op stack K1 = %d (design and layout %.2f s)"
        % (len(lists), len(final), depth, target.num_params, len(target.operations),
           [str(k) for k in target.op_keys[len(target.operations):]], K1, time.time() - t0))
    if (len(final), depth, target.num_params, len(target.operations), K1) != \
            (19590, 70, 1360, 5, 9):
        raise SystemExit("unexpected smq2Q_XXYYII design or op stack")
    errs, kms, kplain, _, kbound, shapes = hold_kernel_at_buckets(layout, target, device,
                                                                  'parallel')
    log("parallel: kernel bwd_jacobian at this layout's %d bucket shapes %s: max rel err f64 "
        "%.3e (tol 1e-12), f32 %.3e (tol 1e-5); %.4f ms per Jacobian f64 against a bound of "
        "%.4f ms (%.1f%% of it; plain %.2f ms)"
        % (len(shapes), shapes, errs[torch.float64], errs[torch.float32], kms, kbound,
           100 * kbound / kms, kplain))
    datagen = xp.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01)
    t0 = time.time()
    ds = simulate_data(datagen, final, 1000, seed=1234, device=device)
    log("parallel: data simulated on the card in %.2f s" % (time.time() - t0))
    gst = GateSetTomography(GSTInitialModel(model=target.copy()), gaugeopt_suite=None,
                            objfn_builders=builders, optimizer={'maxiter': LM_MAXITER},
                            verbosity=0, device=device)
    est, launches, fit_s, iters, peak = fit_launches(
        gst, ProtocolData(GateSetTomographyDesign(target, lists), ds), 'parallel', lists)
    nsigma = est.misfit_sigma()
    log("parallel: %d circuits, %d parameters, K1 %d: %d LM iterations in %.3f s, %.1f ms per "
        "iteration; kernel launches {'bwd_jacobian': %d}; final 2*DeltaLogL %.6f, k %d, "
        "N_sigma %.4f; peak device memory %.1f MB"
        % (len(final), target.num_params, K1, iters, fit_s, 1e3 * fit_s / max(iters, 1),
           launches, est.parameters['final_objfn_value'], est.parameters['final_dof'],
           nsigma, peak))
    fitted = est.models['final iteration estimate']
    if launches == 0:
        raise SystemExit("the parallel-layer fit never launched the bwd_jacobian kernel")
    if not (np.all(np.isfinite(fitted.to_vector())) and nsigma < 10):
        raise SystemExit("the parallel-layer fit is not finite or far from the statistical "
                         "optimum: N_sigma %g" % nsigma)
    check = [c for c in final if any(len(l.components) > 1 for l in c.layertup)]
    check = check[:: max(1, len(check) // 200)][:200]
    sim = SimpleForwardSimulator(fitted, device)
    p_card = sim.bulk_fill_probs(None, sim.create_layout(check))
    dp_ref = float(np.max(np.abs(p_card - reference_probs(fitted, check))))
    group = FullGaugeGroup(fitted.dim)
    el = group.compute_element(group.initial_params()
                               + 1e-3 * np.random.RandomState(5).randn(group.num_params))
    moved = fitted.copy()
    moved.transform_inplace(el)
    sim2 = SimpleForwardSimulator(moved, device)
    dp_gauge = float(np.max(np.abs(sim2.bulk_fill_probs(None, sim2.create_layout(check)) - p_card)))
    log("parallel: probabilities of %d circuits with parallel layers vs a numpy reference that "
        "multiplies the components: max |dp| %.3e (tol 1e-10); after a random gauge "
        "transformation near the identity (Frobenius distance %.3e): max |dp| %.3e (tol 1e-9)"
        % (len(check), dp_ref, moved.frobeniusdist(fitted), dp_gauge))
    if not (dp_ref < 1e-10 and dp_gauge < 1e-9 and moved.frobeniusdist(fitted) > 1e-5):
        raise SystemExit("parallel-layer probabilities disagree with the reference or move "
                         "under a gauge transformation")
    return launches, errs


def phase_fpr_fit(mp, target, ds, final, builders, device):
    """Phase 11: the fiducial-pair-reduced design of the main path's pack
    fitted on the main path's data; returns its launch count."""
    from pygsti_tpu_torch.protocols.gst import GateSetTomography, GSTInitialModel
    from pygsti_tpu_torch.protocols.protocol import ProtocolData

    t0 = time.time()
    design = mp.create_gst_experiment_design(64, fpr=True)
    sizes = [len(l) for l in design.circuit_lists]
    known = set(final)
    outside = sum(c not in known for c in design.circuit_lists[-1])
    log("fpr: smq2Q_XYICNOT create_gst_experiment_design(64, fpr=True): lists %s (%.2f s); "
        "%d of its circuits outside phase 3's design" % (sizes, time.time() - t0, outside))
    if sizes != [907, 1082, 1376, 1757, 2138, 2519, 2900] or outside:
        raise SystemExit("unexpected fiducial-pair-reduced design")
    gst = GateSetTomography(GSTInitialModel(model=target.copy()), gaugeopt_suite=None,
                            objfn_builders=builders, optimizer={'maxiter': LM_MAXITER},
                            verbosity=0, device=device)
    est, launches, fit_s, iters, peak = fit_launches(gst, ProtocolData(design, ds), 'fpr',
                                                     design.circuit_lists)
    nsigma = est.misfit_sigma()
    log("fpr: %d circuits, %d parameters: %d LM iterations in %.3f s, %.1f ms per iteration; "
        "kernel launches {'bwd_jacobian': %d}; final 2*DeltaLogL %.6f, k %d, N_sigma %.4f; "
        "peak device memory %.1f MB"
        % (sizes[-1], target.num_params, iters, fit_s, 1e3 * fit_s / max(iters, 1), launches,
           est.parameters['final_objfn_value'], est.parameters['final_dof'], nsigma, peak))
    if launches == 0:
        raise SystemExit("the FPR fit never launched the bwd_jacobian kernel")
    if not (np.all(np.isfinite(est.models['final iteration estimate'].to_vector()))
            and nsigma < 10):
        raise SystemExit("the FPR fit is not finite or far from the statistical optimum: "
                         "N_sigma %g" % nsigma)
    return launches


def phase_qutrit_fit(builders, device):
    """Phase 12: the legacy qutrit pack stdQT_XYIMS at full width and depth;
    returns (launches, kernel numbers at the layout's buckets)."""
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.modelpacks.legacy import stdQT_XYIMS as qt
    from pygsti_tpu_torch.models.gaugegroup import TPGaugeGroup
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                GSTInitialModel)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData

    t0 = time.time()
    target = qt.target_model('full TP')
    lists = create_lsgst_circuit_lists(target, qt.prepStrs, qt.effectStrs, qt.germs,
                                       [1, 2, 4, 8, 16, 32, 64])
    final = list(lists[-1])
    sizes = [len(l) for l in lists]
    depth = max(c.depth for c in final)
    layout = SimpleForwardSimulator(target, device).create_layout(final)
    n_out = layout.num_elements // layout.num_rows
    K1 = len(target.op_keys) + 1
    log("qutrit: stdQT_XYIMS 'full TP', %d germs, lists %s, depth %d, %d parameters, d %d, "
        "%d outcomes, K1 %d (design and layout %.2f s)"
        % (len(qt.germs), sizes, depth, target.num_params, target.dim, n_out, K1,
           time.time() - t0))
    if (sizes[-1], depth, target.num_params, target.dim, n_out, K1) != \
            (19971, 69, 314, 9, 3, 5):
        raise SystemExit("unexpected qutrit design or model")
    p_bare = target.probabilities(qt.germs[9], device=device)
    log("qutrit: bare-name circuit germs[9] = %s at the target: %s"
        % (qt.germs[9].str, dict(p_bare)))
    if not abs(p_bare[('1bright',)] - 0.5) < 1e-12:
        raise SystemExit("the bare-name qutrit circuit GxGy does not give p('1bright') = 0.5")
    kernel = hold_kernel_at_buckets(layout, target, device, 'qutrit')
    errs, kms, kplain, keinsum, kbound, shapes = kernel
    log("qutrit: kernel bwd_jacobian at this layout's %d bucket shapes %s: max rel err f64 "
        "%.3e (tol 1e-12), f32 %.3e (tol 1e-5); %.4f ms per Jacobian f64 against a bound of "
        "%.4f ms (%.1f%% of it); plain %.2f ms, einsum yardstick %.2f ms"
        % (len(shapes), shapes, errs[torch.float64], errs[torch.float32], kms, kbound,
           100 * kbound / kms, kplain, keinsum))
    datagen = qt.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.001)
    t0 = time.time()
    ds = simulate_data(datagen, final, 1000, seed=1234, device=device)
    log("qutrit: data simulated on the card in %.2f s" % (time.time() - t0))
    gst = GateSetTomography(GSTInitialModel(model=target.copy()), gaugeopt_suite=None,
                            objfn_builders=builders, optimizer={'maxiter': LM_MAXITER},
                            verbosity=0, device=device)
    est, launches, fit_s, iters, peak = fit_launches(
        gst, ProtocolData(GateSetTomographyDesign(target, lists), ds), 'qutrit', lists)
    nsigma = est.misfit_sigma()
    log("qutrit: %d circuits, %d parameters: %d LM iterations in %.3f s, %.1f ms per "
        "iteration; kernel launches {'bwd_jacobian': %d}; final 2*DeltaLogL %.6f, k %d, "
        "N_sigma %.4f; peak device memory %.1f MB"
        % (len(final), target.num_params, iters, fit_s, 1e3 * fit_s / max(iters, 1), launches,
           est.parameters['final_objfn_value'], est.parameters['final_dof'], nsigma, peak))
    fitted = est.models['final iteration estimate']
    if launches == 0:
        raise SystemExit("the qutrit fit never launched the bwd_jacobian kernel")
    if not (np.all(np.isfinite(fitted.to_vector())) and nsigma < 10):
        raise SystemExit("the qutrit fit is not finite or far from the statistical optimum: "
                         "N_sigma %g" % nsigma)
    check = final[:: len(final) // 200][:200]
    sim = SimpleForwardSimulator(fitted, device)
    p_card = sim.bulk_fill_probs(None, sim.create_layout(check))
    dp_ref = float(np.max(np.abs(p_card - reference_probs(fitted, check))))
    group = TPGaugeGroup(fitted.dim)
    el = group.compute_element(group.initial_params()
                               + 1e-3 * np.random.RandomState(5).randn(group.num_params))
    moved = fitted.copy()
    moved.transform_inplace(el)
    sim2 = SimpleForwardSimulator(moved, device)
    dp_gauge = float(np.max(np.abs(sim2.bulk_fill_probs(None, sim2.create_layout(check)) - p_card)))
    log("qutrit: probabilities of %d circuits vs a numpy product of the 9x9 "
        "superoperators: max |dp| %.3e (tol 1e-10); after a random TP gauge transformation "
        "(Frobenius distance %.3e): max |dp| %.3e (tol 1e-9)"
        % (len(check), dp_ref, moved.frobeniusdist(fitted), dp_gauge))
    if not (dp_ref < 1e-10 and dp_gauge < 1e-9 and moved.frobeniusdist(fitted) > 1e-5):
        raise SystemExit("qutrit probabilities disagree with the reference or move under a "
                         "gauge transformation")
    return launches, kernel


def phase_rpe(device):
    """Phase 13: robust phase estimation of an over-rotated Gxpi2 at depths
    up to 1,025, and the config-driven analysis of extras/rpe."""
    import scipy.linalg
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.extras.rpe import rpeconfig_gxpi2_gypi2_00 as cfg
    from pygsti_tpu_torch.extras.rpe import rpeconstruction as rc
    from pygsti_tpu_torch.extras.rpe import rpetools as rt
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.modelmembers.operations import FullTPOp
    from pygsti_tpu_torch.modelpacks import smq1Q_XYI, smq1Q_Xpi2_rpe
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    from pygsti_tpu_torch.protocols.rpe import RobustPhaseEstimationProtocol
    from pygsti_tpu_torch.tools.internalgates import sigmaX
    from pygsti_tpu_torch.tools.optools import unitary_to_superop

    t0 = time.time()
    design = smq1Q_Xpi2_rpe.create_rpe_experiment_design(1024)
    circuits = design.all_circuits_needing_data
    depth = max(c.depth for c in circuits)
    over = 0.01
    true_angle = np.pi / 2 + over
    model = smq1Q_XYI.target_model('full TP')
    model.operations[('Gxpi2', 0)] = FullTPOp(np.real(unitary_to_superop(
        scipy.linalg.expm(-0.5j * true_angle * sigmaX))))
    ds = simulate_data(model, circuits, 1000, seed=1234, device=device)
    res = RobustPhaseEstimationProtocol().run(ProtocolData(design, ds))
    est = res.angle_estimates
    log("rpe: smq1Q_Xpi2_rpe design at max length 1024: %d circuits, depth up to %d; Gxpi2 "
        "over-rotated by %.3f rad (true angle %.12f); 1000 shots simulated on the card; "
        "estimate per generation (depth 1, 2, 4, ...): %s; last %.12f, error %.3e rad "
        "(tol 1e-3) (%.2f s)"
        % (len(circuits), depth, over, true_angle, ["%.6f" % a for a in est], est[-1],
           abs(est[-1] - true_angle), time.time() - t0))
    if (len(circuits), depth) != (22, 1025) or not abs(est[-1] - true_angle) < 1e-3:
        raise SystemExit("robust phase estimation missed the true angle")
    deepest = [c for c in circuits if c.depth == depth]
    sim = SimpleForwardSimulator(model, device)
    p_card = sim.bulk_fill_probs(None, sim.create_layout(deepest))
    G = model.operations[('Gxpi2', 0)].dense()
    rho = model.preps['rho0'].dense()
    p_ref = model.povms['Mdefault'].dense() @ np.linalg.matrix_power(G, depth) @ rho
    dp = float(np.max(np.abs(p_card - p_ref)))
    log("rpe: probabilities at depth %d on the card vs a numpy power of the 4x4 "
        "superoperator: max |dp| %.3e (tol 1e-10)" % (depth, dp))
    if not dp < 1e-10:
        raise SystemExit("the card's probabilities at depth %d disagree with numpy" % depth)
    t0 = time.time()
    d = rc.create_rpe_angle_circuits_dict(10, cfg)
    alpha_true, eps_true = np.pi / 2 + 0.01, np.pi / 2 - 0.005
    rmodel = rc.create_parameterized_rpe_model(alpha_true, eps_true, 0.002, 1e-3, 1e-4,
                                               rpeconfig_inst=cfg)
    rds = rc.create_rpe_dataset(rmodel, d, 1000, seed=42, device=device)
    out = rt.analyze_rpe_data(rds, rmodel, d, cfg)
    log("rpe: extras/rpe on card-simulated data of %d circuits (k up to %d, depth up to %d): "
        "alpha error %.3e, epsilon error %.3e (tol 1e-3), theta %.6f (true %.6f) (%.2f s)"
        % (len(d['totalCircList']), d['k_list'][-1],
           max(c.depth for c in d['totalCircList']), out['alphaErrorList'][-1],
           out['epsilonErrorList'][-1], out['thetaHatList'][-1], rt.extract_theta(rmodel, cfg),
           time.time() - t0))
    if not (out['alphaErrorList'][-1] < 1e-3 and out['epsilonErrorList'][-1] < 1e-3):
        raise SystemExit("extras/rpe did not recover alpha and epsilon")


def phase_objectives(target, lists, ds, est3, fit_value, device):
    """Phase 14: on phase 3's data and design, (a) the fit with the
    frequency-weighted chi2 stages through the host LM loop, (b) the final
    list's logL by the device loop with the CG and the Cholesky solve, (c)
    every other raw objective on the card against the CPU, (d) the
    out-of-bounds interval without a predicate; returns {path: launches}."""
    from pygsti_tpu_torch.objectivefns import objectivefns as of
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    from pygsti_tpu_torch.optimize.simplerlm import CustomLMOptimizer
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                GSTInitialModel, GSTObjFnBuilders)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData

    launches = {}
    final, small = list(lists[-1]), list(lists[0])
    # (a) the host loop on the card's tensors
    gst = GateSetTomography(GSTInitialModel(model=target.copy()), gaugeopt_suite=None,
                            objfn_builders=GSTObjFnBuilders.create_from(
                                'logl', freq_weighted_chi2=True),
                            optimizer=CustomLMOptimizer(damping_mode='JTJ'), verbosity=0,
                            device=device)
    est, launches['host-loop fit'], fit_s, iters, peak = fit_launches(
        gst, ProtocolData(GateSetTomographyDesign(target, lists), ds), 'host', lists)
    evals = sum(r.optimizer_specific_qtys['evaluations']
                for rs in est.parameters['optimizer_results'] for r in rs)
    value = est.parameters['final_objfn_value']
    rel = abs(value - fit_value) / fit_value
    log("host: 'fwchi2' stages then 'logl', CustomLMOptimizer(damping_mode='JTJ') on the "
        "host: %d iterations in %.3f s (%.1f ms each), %d objective evaluations read from the "
        "card (%.2f per iteration), kernel launches %d; final 2*DeltaLogL %.6f against phase "
        "3's %.6f: rel %.3e (tol 1e-3)"
        % (iters, fit_s, 1e3 * fit_s / max(iters, 1), evals, evals / max(iters, 1),
           launches['host-loop fit'], value, fit_value, rel))
    if launches['host-loop fit'] == 0 or not rel < 1e-3:
        raise SystemExit("the host-loop fit missed phase 3's optimum: rel %.3e" % rel)
    # (b) the device loop's two solvers on the final list's logL, from the
    # estimate of the list before it
    start = est3.models['iteration %d estimate' % (len(lists) - 2)]
    values = {}
    for solver in ('cholesky', 'cg'):
        mdl = start.copy()
        obj = of.ObjectiveFunctionBuilder('logl').build(mdl, ds, final, device=device)
        torch.cuda.synchronize()
        bwd_jacobian_accumulate.launches = 0
        t0 = time.time()
        x, conv, msg, mu, nu, norm_f, f, k = obj.run_device_lm(mdl.to_vector(),
                                                              maxiter=LM_MAXITER,
                                                              solver=solver)
        torch.cuda.synchronize()
        launches['%s fit' % solver] = bwd_jacobian_accumulate.launches
        values[solver] = 2 * norm_f
        log("solver %s: final list's logL from the estimate of list %d: %d iterations in "
            "%.3f s, kernel launches %d, 2*DeltaLogL %.6f (%s)"
            % (solver, len(lists) - 2, k, time.time() - t0, launches['%s fit' % solver],
               values[solver], msg))
        if not conv:
            raise SystemExit("the device loop with solver %s did not converge: %s"
                             % (solver, msg))
    rel_cg = abs(values['cg'] - values['cholesky']) / values['cholesky']
    rel_3 = max(abs(v - fit_value) / fit_value for v in values.values())
    log("solver: CG against Cholesky rel %.3e, both against phase 3's value rel <= %.3e "
        "(tol 1e-3)" % (rel_cg, rel_3))
    if not (rel_cg < 1e-3 and rel_3 < 1e-3):
        raise SystemExit("the CG and Cholesky fits disagree or miss phase 3's optimum")
    # (c) each raw objective at phase 3's fitted point, card against CPU
    fitted = est3.models['final iteration estimate']
    theta = fitted.to_vector()
    raws = [(name, lambda name=name: of._RAW_CLASSES[name]()) for name in
            ('fwchi2', 'dlogl-nonpoisson', 'tvd', 'chialpha', 'cwchi2', 'maxlogl')]
    raws.append(('Lp^p (p = 2)', lambda: of.RawAbsPower(2)))
    for name, make in raws:
        objs = [of.TimeIndependentMDCObjectiveFunction(make(), fitted, ds, small, device=dev)
                for dev in (device, 'cpu')]
        fn_c, fn_h = (o.fn(theta) for o in objs)
        (ls_c, jtj_c, jtf_c), (ls_h, jtj_h, jtf_h) = (o.jtj_jtf(theta) for o in objs)
        nan_ls = np.isnan(ls_h)
        if name == 'maxlogl':
            # its terms c (log f - 1) are negative wherever c > 0, so lsvec =
            # sqrt(terms) is NaN there in both packages: only fn and the
            # places of the NaNs can agree
            same_nans = np.array_equal(np.isnan(ls_c), nan_ls)
            rel_fn = abs(fn_c - fn_h) / abs(fn_h)
            log("objective %s (%d circuits): fn card %.12g, CPU %.12g, rel %.3e (tol 1e-9); "
                "lsvec NaN at %d of %d elements on both: %s"
                % (name, len(small), fn_c, fn_h, rel_fn, int(nan_ls.sum()), len(ls_h),
                   same_nans))
            if not (rel_fn < 1e-9 and same_nans):
                raise SystemExit("objective %s disagrees between the card and the CPU" % name)
            continue
        rels = [abs(fn_c - fn_h) / abs(fn_h)] + [
            float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
            for a, b in ((ls_c, ls_h), (jtj_c, jtj_h), (jtf_c, jtf_h))]
        log("objective %s (%d circuits): fn %.12g; card vs CPU rel diff fn %.3e, lsvec %.3e, "
            "JTJ %.3e, JTf %.3e (tol 1e-9)" % ((name, len(small), fn_h) + tuple(rels)))
        if not max(rels) < 1e-9:
            raise SystemExit("objective %s disagrees between the card and the CPU: %s"
                             % (name, rels))
    # (d) an out-of-bounds interval with no predicate changes nothing
    xs = []
    for interval in (0, 1):
        obj = of.ObjectiveFunctionBuilder('logl').build(target.copy(), ds, small,
                                                        device=device)
        xs.append(obj.run_device_lm(target.to_vector(), maxiter=LM_MAXITER,
                                    oob_check_interval=interval))
    same = np.array_equal(xs[0][0], xs[1][0])
    log("oob: the device loop on the first list from the target with oob_check_interval 0 "
        "and 1, no out-of-bounds predicate: %d and %d iterations, x equal bit for bit: %s"
        % (xs[0][7], xs[1][7], same))
    if not same:
        raise SystemExit("oob_check_interval=1 without a predicate changed the fit")
    return launches


CLOUD_GATES = ['Gxpi2', 'Gypi2', 'Gcnot']
CLOUD_FIDS = [(), ('Gxpi2',), ('Gypi2',), ('Gxpi2', 'Gxpi2')]
CLOUD_MAXL = 64
# phase 20's depth cut: the 3-qubit design's longest germ power
CLOUD3_MAXL = 64
# circuits of phase 20's design at maxL 2 on the CPU path:
# create_cloudnoise_circuits(QubitProcessorSpec(3, CLOUD_GATES, geometry='line'), [1, 2],
# CLOUD_FIDS, max_idle_weight=1, maxhops=1, extra_gate_weight=1, seed=3, device='cpu')
# (about 5 minutes on one CPU)
CLOUD3_CPU_MAXL2 = 323
# phase 15's two sizes: (circuits, one-qubit layers per circuit)
CLOUD5_SIZES = ((40, 6), (1000, 24))


def bench_q5_circuits(n, n1q, seed=2026):
    """bench.py's 5-qubit recipe: n circuits of n1q one-qubit layers on
    random qubits, a CNOT on a random neighbouring pair after every second
    one, on lines (0,1,2,3,4); drawn from RandomState(seed) alone (bench.py
    draws them after its 3-qubit cell has consumed the generator, so its
    circuits differ)."""
    from pygsti_tpu_torch.circuits.circuit import Circuit
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        layers = []
        for t in range(n1q):
            q = rng.randint(5)
            layers.append("%s:%d" % (['Gxpi2', 'Gypi2'][rng.randint(2)], q))
            if t % 2 == 1:
                c0 = rng.randint(4)
                layers.append("Gcnot:%d:%d" % (c0, c0 + 1))
        out.append(Circuit(''.join(layers) + '@(0,1,2,3,4)'))
    return out


def numpy_cloud_probs(model, circuit):
    """Outcome probabilities of one circuit of a 5-qubit implicit model by
    numpy alone: every factor of a layer (a leaf's dense superoperator on
    contiguous ascending qubits) Kronecker-embedded as I (x) M (x) I, the
    factors multiplied in the layer's order, the layers in the circuit's."""
    n = model.num_qubits
    leaves = model._leaves()
    rho = model.preps['rho0'].dense()
    for layer in circuit.layertup:
        for key, targets in model._layer_recipes[model.op_keys.index(layer)]:
            q = [model.state_space.qubit_labels.index(t) for t in targets]
            if q != list(range(q[0], q[0] + len(q))):
                raise SystemExit("the numpy reference takes contiguous ascending targets")
            mx = np.kron(np.kron(np.eye(4 ** q[0]), leaves[key].dense()),
                         np.eye(4 ** (n - q[-1] - 1)))
            rho = mx @ rho
    return model.povms['Mdefault'].dense() @ rho


def phase_cloud5(device):
    """Phase 15: the JAX package's 5-qubit cloud-noise cell (bench.py
    bench[q5]) on the card at two sizes; returns ({size: circuits},
    model)."""
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.models.cloudnoisemodel import \
        create_cloud_crosstalk_model_from_hops_and_weights
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
    from pygsti_tpu_torch.protocols.modeltest import ModelTest
    from pygsti_tpu_torch.protocols.protocol import ExperimentDesign, ProtocolData

    t0 = time.time()
    pspec5 = QubitProcessorSpec(5, CLOUD_GATES, geometry='line')
    mdl = create_cloud_crosstalk_model_from_hops_and_weights(
        pspec5, maxhops=1, max_idle_weight=1, extra_gate_weight=0, gate_type='H+s')
    v = np.zeros(mdl.num_params)
    v[:8] = 0.005
    mdl.from_vector(v)
    log("cloud5: cloud-noise model of QubitProcessorSpec(5, %s, 'line'), maxhops 1, idle "
        "weight 1, 'H+s', v[:8] = 0.005: %d parameters, d %d (built on the host in %.2f s)"
        % (CLOUD_GATES, mdl.num_params, mdl.dim, time.time() - t0))
    if (mdl.num_params, mdl.dim) != (594, 1024):
        raise SystemExit("unexpected 5-qubit cloud model")
    designs = {}
    for n, n1q in CLOUD5_SIZES:
        tag = "cloud5[%d]" % n
        circuits = bench_q5_circuits(n, n1q)
        designs[n] = circuits
        sim = SimpleForwardSimulator(mdl, device)
        layout = sim.create_layout(circuits)
        torch.cuda.synchronize()
        t0 = time.time()
        p = sim.bulk_fill_probs(None, layout)
        cold = time.time() - t0
        t0 = time.time()
        p = sim.bulk_fill_probs(None, layout)
        warm = time.time() - t0
        n_ops = len(mdl.op_keys)
        log("%s: %d circuits of %d one-qubit layers and %d CNOTs (depth %d), %d distinct "
            "layers; bulk probabilities on the card cold %.3f s, warm %.3f s (%.1f circuits/s); "
            "the gathered scan would move %.1f MB per layer, the grouped one reads at most "
            "%.1f MB of ops per layer"
            % (tag, n, n1q, n1q // 2, circuits[0].depth, n_ops, cold, warm, n / warm,
               n * mdl.dim ** 2 * 8 / 1e6, min(n_ops + 1, n) * mdl.dim ** 2 * 8 / 1e6))
        check = circuits[:40]
        cpu = SimpleForwardSimulator(mdl, 'cpu')
        p_cpu = cpu.bulk_fill_probs(None, cpu.create_layout(check))
        dp_cpu = float(np.max(np.abs(p[:len(check) * 32] - p_cpu)))
        p_np = np.concatenate([numpy_cloud_probs(mdl, c) for c in circuits[:5]])
        dp_np = float(np.max(np.abs(p[:5 * 32] - p_np)))
        dsum = float(np.max(np.abs(p.reshape(n, 32).sum(axis=1) - 1)))
        log("%s: card vs the CPU path on %d circuits max |dp| %.3e (tol 1e-10); 5 circuits vs "
            "a numpy product of the Kronecker-embedded leaves %.3e (tol 1e-10); per-circuit "
            "sums within %.3e of 1 (tol 1e-10)" % (tag, len(check), dp_cpu, dp_np, dsum))
        if not (dp_cpu < 1e-10 and dp_np < 1e-10 and dsum < 1e-10 and np.all(np.isfinite(p))):
            raise SystemExit("5-qubit probabilities disagree with the CPU path or numpy")
        t0 = time.time()
        ds = simulate_data(mdl, circuits, 500, seed=77, record_zero_counts=False, device=device)
        sim_s = time.time() - t0
        sparse = sim.create_layout(circuits, ds)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        res = ModelTest(mdl, verbosity=0, device=device).run(
            ProtocolData(ExperimentDesign(circuits), ds), disable_checkpointing=True)
        torch.cuda.synchronize()
        mt_wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 1e6
        est = res.estimates['ModelTest']
        nsig = est.misfit_sigma()
        log("%s: simulate_data(500 shots, seed 77, record_zero_counts=False) %.3f s; sparse "
            "layout %d elements of %d dense (32 x circuits); ModelTest %.3f s, 2*DeltaLogL "
            "%.6f, k %d, N_sigma %.4f, peak device memory %.1f MB"
            % (tag, sim_s, sparse.num_elements, 32 * n, mt_wall,
               est.parameters['final_objfn_value'], est.parameters['final_dof'], nsig, peak))
        if not (np.isfinite(nsig) and abs(nsig) < 10 and sparse.num_elements < 32 * n):
            raise SystemExit("the 5-qubit ModelTest is not finite or far from its optimum: "
                             "N_sigma %g" % nsig)
    return designs, mdl


def phase_cloudfit(device):
    """Phase 16: a 2-qubit cloud-noise fit through the kernel; returns
    (launches, kernel numbers at the layout's buckets)."""
    from pygsti_tpu_torch.algorithms.core import run_gst_fit_simple
    from pygsti_tpu_torch.circuits.cloudcircuitconstruction import create_cloudnoise_circuits
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.models.cloudnoisemodel import \
        create_cloud_crosstalk_model_from_hops_and_weights
    from pygsti_tpu_torch.objectivefns.objectivefns import two_delta_logl
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec

    spec = QubitProcessorSpec(2, CLOUD_GATES, geometry='line')
    maxls = [L for L in (1, 2, 4, 8, 16, 32, 64) if L <= CLOUD_MAXL]
    t0 = time.time()
    struct = create_cloudnoise_circuits(spec, maxls, CLOUD_FIDS, max_idle_weight=1, maxhops=1,
                                        extra_gate_weight=1, seed=3, device=device)
    circuits = list(struct)
    design_s = time.time() - t0

    def cloud_model():
        return create_cloud_crosstalk_model_from_hops_and_weights(
            spec, maxhops=1, max_idle_weight=1, extra_gate_weight=1, gate_type='H+s')
    truth = cloud_model()
    # small positive rates (an 'H+s' stochastic rate below 0 is not a channel)
    vt = 0.002 * np.abs(np.random.RandomState(16).randn(truth.num_params))
    lbls = truth.idle_member.errorgen.blocks[0].basis_element_labels
    planted = truth.idle_member.gpindices.start + lbls.index('XI')
    vt[planted] = 0.03
    truth.from_vector(vt)
    ds = simulate_data(truth, circuits, 1000, seed=1616, device=device)
    start = cloud_model()
    layout = SimpleForwardSimulator(start, device).create_layout(circuits, ds)
    K1 = len(start.op_keys) + 1
    n_par = sum(len(k.components) > 1 for k in start.op_keys)
    log("cloudfit: create_cloudnoise_circuits(maxL %s, maxhops 1, extra gate weight 1, seed 3) "
        "on the card: %d circuits, depth up to %d, %d germs, in %.2f s; model %d parameters, "
        "K1 %d (%d parallel layers), d %d"
        % (maxls[-1], len(circuits), max(c.depth for c in circuits), len(struct.ys), design_s,
           start.num_params, K1, n_par, start.dim))
    kernel = hold_kernel_at_buckets(layout, start, device, 'cloudfit')
    errs, kms, kplain, keinsum, kbound, shapes = kernel
    log("cloudfit: kernel bwd_jacobian at this layout's %d bucket shapes %s: max rel err f64 "
        "%.3e (tol 1e-12), f32 %.3e (tol 1e-5); %.4f ms per Jacobian f64 against a bound of "
        "%.4f ms (%.1f%% of it); plain %.2f ms, einsum yardstick %.2f ms"
        % (len(shapes), shapes, errs[torch.float64], errs[torch.float32], kms, kbound,
           100 * kbound / kms, kplain, keinsum))
    x = torch.as_tensor(vt, device=device)
    t0 = time.time()
    Tv = start.flat_tensors_jacobian_fn()(x)
    torch.cuda.synchronize()
    tv_s = time.time() - t0
    dTv = float((Tv - torch.func.jacfwd(start.flat_tensors_fn())(x)).abs().max())
    log("cloudfit: Tv [%d x %d] by the leaves' jvp and the product rule on the card in %.3f s; "
        "against torch.func.jacfwd max |d| %.3e (tol 1e-12)" % (*Tv.shape, tv_s, dTv))
    if not dTv < 1e-12:
        raise SystemExit("the implicit model's Tv disagrees with jacfwd")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bwd_jacobian_accumulate.launches = 0
    t0 = time.time()
    iters = []
    for name in ('chi2', 'logl'):
        result, objective = run_gst_fit_simple(ds, start, circuits, {'maxiter': LM_MAXITER},
                                               name, device=device)
        q = result.optimizer_specific_qtys
        iters.append(q['iterations'])
        log("cloudfit: %s from %s: %d LM iterations, %.3f s, objective %.6f, jac_mode %s, %s"
            % (name, 'zero' if name == 'chi2' else 'the chi2 fit', q['iterations'],
               q['wall_s'], result.f, objective.jac_mode, q['msg']))
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = bwd_jacobian_accumulate.launches
    peak = torch.cuda.max_memory_allocated() / 1e6
    tdl_fit = two_delta_logl(start, ds, circuits, device=device)
    tdl_truth = two_delta_logl(truth, ds, circuits, device=device)
    k = ds.degrees_of_freedom(circuits) - start.num_params
    nsig = (tdl_fit - k) / np.sqrt(2 * k)
    rate = float(start.to_vector()[planted])
    log("cloudfit: %d + %d LM iterations in %.3f s; kernel launches {'bwd_jacobian': %d}; "
        "2*DeltaLogL %.6f (the truth's %.6f), k %d, N_sigma %.4f; planted idle H_X 0.03, "
        "fitted %.6f; peak device memory %.1f MB"
        % (iters[0], iters[1], fit_s, launches, tdl_fit, tdl_truth, k, nsig, rate, peak))
    if launches == 0:
        raise SystemExit("the cloud-noise fit never launched the bwd_jacobian kernel")
    if not (abs(rate - 0.03) < 0.01 and tdl_fit < tdl_truth + 10 and abs(nsig) < 10):
        raise SystemExit("the cloud-noise fit missed the planted rate or the optimum")
    return launches, kernel


def phase_statevec(designs, device):
    """Phase 17: the state-vector simulator against the superoperator one
    on phase 15's circuits, a 5-qubit model of static unitaries."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.forwardsims.statevecsim import StateVectorForwardSimulator
    from pygsti_tpu_torch.models.modelconstruction import create_explicit_model
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec

    t0 = time.time()
    mdl = create_explicit_model(QubitProcessorSpec(5, CLOUD_GATES, geometry='line'),
                                ideal_gate_type='static unitary')
    log("statevec: create_explicit_model(5 qubits, 'static unitary'): %d operations, d %d, "
        "built on the host in %.2f s" % (len(mdl.operations), mdl.dim, time.time() - t0))
    for n, circuits in designs.items():
        times, probs = {}, {}
        for name, cls in (('statevec', StateVectorForwardSimulator),
                          ('superop', SimpleForwardSimulator)):
            sim = cls(mdl, device)
            layout = sim.create_layout(circuits)
            sim.bulk_fill_probs(None, layout)
            torch.cuda.synchronize()
            t0 = time.time()
            probs[name] = sim.bulk_fill_probs(None, layout)
            times[name] = time.time() - t0
        dp = float(np.max(np.abs(probs['statevec'] - probs['superop'])))
        log("statevec[%d]: warm bulk probabilities on the card: state vectors (u 32) %.4f s, "
            "superoperators (d 1,024) %.4f s; max |dp| %.3e (tol 1e-12)"
            % (n, times['statevec'], times['superop'], dp))
        if not dp < 1e-12:
            raise SystemExit("the state-vector probabilities disagree with the superoperator ones")


def ideal_probs(layout, probs, ideals):
    """Each circuit's probability of its ideal outcome, from the flat
    probabilities of `layout`."""
    p = probs.reshape(layout.num_rows, -1)
    return np.array([p[b, layout.outcomes[b].index((''.join(str(x) for x in ideal),))]
                     for b, ideal in enumerate(ideals)])


def rb_checks(tag, pspec, circuits, ideals, mdl, device):
    """Card against CPU (1e-10), sums to 1 (1e-12), the noiseless model's
    ideal outcomes (1e-10) and the stabilizer simulator's (exactly 1);
    returns the card's probabilities of the ideal outcomes under `mdl`."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.forwardsims.stabilizersim import StabilizerForwardSimulator
    from pygsti_tpu_torch.models.modelconstruction import create_crosstalk_free_model
    sim = SimpleForwardSimulator(mdl, device)
    layout = sim.create_layout(circuits)
    p = sim.bulk_fill_probs(None, layout)
    cpu = SimpleForwardSimulator(mdl, 'cpu')
    dp = float(np.max(np.abs(p - cpu.bulk_fill_probs(None, cpu.create_layout(circuits)))))
    dsum = float(np.max(np.abs(p.reshape(layout.num_rows, -1).sum(axis=1) - 1)))
    ideal = create_crosstalk_free_model(pspec, depolarization_strengths={
        g: 0.0 for g in pspec.gate_names})
    isim = SimpleForwardSimulator(ideal, device)
    ilayout = isim.create_layout(circuits)
    d_ideal = float(np.max(np.abs(ideal_probs(ilayout, isim.bulk_fill_probs(None, ilayout), ideals)
                                  - 1)))
    stab = StabilizerForwardSimulator(pspec)
    n_stab = sum(stab.probability(c, ''.join(str(x) for x in i)) == 1.0
                 for c, i in zip(circuits, ideals))
    log("%s: %d circuits (depth up to %d): card vs CPU max |dp| %.3e (tol 1e-10); sums within "
        "%.3e of 1 (tol 1e-12); the noiseless model gives the ideal outcome within %.3e of 1 "
        "(tol 1e-10); the stabilizer simulator gives it probability 1 for %d of them"
        % (tag, len(circuits), max(c.depth for c in circuits), dp, dsum, d_ideal, n_stab))
    if not (dp < 1e-10 and dsum < 1e-12 and d_ideal < 1e-10 and n_stab == len(circuits)
            and np.all(np.isfinite(p))):
        raise SystemExit("%s: RB circuit probabilities or ideal outcomes are wrong" % tag)
    return ideal_probs(layout, p, ideals)


def rb_fit(tag, design, mdl, device, seed, r_max):
    """1,000 shots of `design` simulated on the card, RandomizedBenchmarking
    with 200 bootstraps, against the fit of the exact success probabilities
    of the same circuits; r must lie in (0, r_max)."""
    from pygsti_tpu_torch.algorithms.rbfit import std_least_squares_fit
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    from pygsti_tpu_torch.protocols.rb import RandomizedBenchmarking
    circuits = list(design.all_circuits_needing_data)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    ds = simulate_data(mdl, circuits, 1000, seed=seed, device=device)
    sim_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e6
    t0 = time.time()
    res = RandomizedBenchmarking(bootstrap_samples=200).run(ProtocolData(design, ds))
    fit_s = time.time() - t0
    sim = SimpleForwardSimulator(mdl, device)
    layout = sim.create_layout(circuits)
    ps = ideal_probs(layout, sim.bulk_fill_probs(None, layout),
                     [i for l in design.idealout_lists for i in l])
    per = len(circuits) // len(design.depths)
    n = len(design.qubit_labels)
    exact = std_least_squares_fit(design.depths, [float(np.mean(ps[k * per:(k + 1) * per]))
                                                  for k in range(len(design.depths))], n)
    r, r_std, r_exact = res.r, res.r_std, exact['estimates']['r']
    log("%s: simulate_data(%d circuits x 1000 shots) on the card %.3f s (peak device memory "
        "%.1f MB); RandomizedBenchmarking (200 bootstraps) %.3f s: r %.6e +/- %.3e (p %.6f), "
        "the exact success probabilities' fit r %.6e; %d of 200 bootstraps fitted"
        % (tag, len(circuits), sim_s, peak, fit_s, r, r_std, res.fits['full']['estimates']['p'],
           r_exact, len(res.bootstraps['full'])))
    if not (res.fits['full']['success'] and exact['success'] and 0 < r < r_max
            and abs(r - r_exact) < 3 * r_std):
        raise SystemExit("%s: the RB fit failed or missed the exact decay: r %g +/- %g, exact %g"
                         % (tag, r, r_std, r_exact))
    return r


def bench_q3_circuits(pspec3):
    """bench[q3]'s 60 direct-RB circuits and ideal outcomes: 10 per depth
    0, 2, 4, 8, 16, 32 on a 3-qubit line, from RandomState(2026)."""
    from pygsti_tpu_torch.algorithms.randomcircuit import create_direct_rb_circuit
    rng = np.random.RandomState(2026)
    circs, ideals = [], []
    for depth in (0, 2, 4, 8, 16, 32):
        for _ in range(10):
            c, ideal = create_direct_rb_circuit(pspec3, length=depth, rand_state=rng)
            circs.append(c)
            ideals.append(ideal)
    return circs, ideals


def phase_q3rb(device):
    """Phase 18: the JAX package's bench[q3] on the card (60 direct-RB
    circuits of a 3-qubit line from RandomState(2026), bulk probabilities
    of a depolarized crosstalk-free model), then a 240-circuit direct-RB
    design simulated on the card and fitted."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.models.modelconstruction import create_crosstalk_free_model
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
    from pygsti_tpu_torch.protocols.rb import DirectRBDesign

    pspec3 = QubitProcessorSpec(3, CLOUD_GATES, geometry='line')
    t0 = time.time()
    circs, ideals = bench_q3_circuits(pspec3)
    gen_s = time.time() - t0
    mdl3 = create_crosstalk_free_model(
        pspec3, depolarization_strengths={g: 0.01 for g in pspec3.gate_names})
    sim = SimpleForwardSimulator(mdl3, device)
    layout = sim.create_layout(circs)
    torch.cuda.synchronize()
    t0 = time.time()
    sim.bulk_fill_probs(None, layout)
    cold = time.time() - t0
    t0 = time.time()
    sim.bulk_fill_probs(None, layout)
    warm = time.time() - t0
    log("q3rb: bench[q3]: %d direct-RB circuits on QubitProcessorSpec(3, %s, 'line') from "
        "RandomState(2026) in %.2f s on the host (depth up to %d, %d distinct layers); bulk "
        "probabilities of the crosstalk-free model (depolarized 0.01) on the card cold %.3f s, "
        "warm %.4f s (%.1f circuits/s on %s)"
        % (len(circs), CLOUD_GATES, gen_s, max(c.depth for c in circs), len(mdl3.op_keys),
           cold, warm, len(circs) / warm, card_name_and_limit()))
    rb_checks('q3rb', pspec3, circs, ideals, mdl3, device)
    t0 = time.time()
    design = DirectRBDesign(pspec3, depths=(0, 2, 4, 8, 16, 32, 64, 128), circuits_per_depth=30,
                            seed=2027)
    log("q3rb: DirectRBDesign(depths 0..128, 30 circuits each): %d circuits, depth up to %d, "
        "in %.2f s on the host" % (len(design.all_circuits_needing_data),
                                   max(c.depth for c in design.all_circuits_needing_data),
                                   time.time() - t0))
    rb_checks('q3rb[design]', pspec3, list(design.all_circuits_needing_data),
              [i for l in design.idealout_lists for i in l], mdl3, device)
    rb_fit('q3rb[design]', design, mdl3, device, seed=2028, r_max=0.2)


def phase_crb2(device):
    """Phase 19: Clifford RB on 2 qubits, simulated on the card and fitted;
    mirror-RB circuits of one depth come back to their ideal outcomes."""
    from pygsti_tpu_torch.models.modelconstruction import create_crosstalk_free_model
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
    from pygsti_tpu_torch.protocols.rb import CliffordRBDesign, MirrorRBDesign

    pspec2 = QubitProcessorSpec(2, CLOUD_GATES, geometry='line')
    mdl2 = create_crosstalk_free_model(
        pspec2, depolarization_strengths={g: 0.01 for g in pspec2.gate_names})
    t0 = time.time()
    design = CliffordRBDesign(pspec2, depths=(0, 1, 2, 4, 8, 16, 32, 64), circuits_per_depth=30,
                              seed=2029)
    circuits = list(design.all_circuits_needing_data)
    log("crb2: CliffordRBDesign(2 qubits, depths 0..64, 30 circuits each): %d circuits, depth "
        "up to %d, in %.2f s on the host"
        % (len(circuits), max(c.depth for c in circuits), time.time() - t0))
    rb_checks('crb2', pspec2, circuits, [i for l in design.idealout_lists for i in l], mdl2,
              device)
    # a compiled 2-qubit Clifford is tens of native gates, each depolarized
    # 0.01, so the exact decay itself gives r near 0.24: the bound is 0.5
    rb_fit('crb2', design, mdl2, device, seed=2030, r_max=0.5)
    mirror = MirrorRBDesign(pspec2, depths=(16,), circuits_per_depth=30, seed=2031)
    rb_checks('crb2[mirror]', pspec2, list(mirror.all_circuits_needing_data),
              mirror.idealout_lists[0], mdl2, device)


def phase_cloudfit3(device):
    """Phase 20: phase 16 at 3 qubits: a 534-parameter cloud-noise fit
    whose op stack (d 64) the kernel reads from global memory; returns
    (launches, kernel numbers at the layout's buckets)."""
    from pygsti_tpu_torch.algorithms.core import run_gst_fit_simple
    from pygsti_tpu_torch.circuits.cloudcircuitconstruction import create_cloudnoise_circuits
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.models.cloudnoisemodel import \
        create_cloud_crosstalk_model_from_hops_and_weights
    from pygsti_tpu_torch.objectivefns.objectivefns import two_delta_logl
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate, g_in_shared_memory
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec

    spec = QubitProcessorSpec(3, CLOUD_GATES, geometry='line')
    maxls = [L for L in (1, 2, 4, 8, 16, 32, 64) if L <= CLOUD3_MAXL]
    t0 = time.time()
    struct = create_cloudnoise_circuits(spec, maxls, CLOUD_FIDS, max_idle_weight=1, maxhops=1,
                                        extra_gate_weight=1, seed=3, device=device)
    circuits = list(struct)
    design_s = time.time() - t0
    maxl2 = len(dict.fromkeys(c for (L, _), plaq in struct.plaquettes.items() if L <= 2
                              for c in plaq.circuits))
    log("cloudfit3: the card's design at maxL 2 holds %d circuits, the CPU path's %d"
        % (maxl2, CLOUD3_CPU_MAXL2))
    if maxl2 != CLOUD3_CPU_MAXL2:
        raise SystemExit("the card's 3-qubit cloud design differs from the CPU path's")

    def cloud_model():
        return create_cloud_crosstalk_model_from_hops_and_weights(
            spec, maxhops=1, max_idle_weight=1, extra_gate_weight=1, gate_type='H+s')
    truth = cloud_model()
    vt = 0.002 * np.abs(np.random.RandomState(16).randn(truth.num_params))
    lbls = truth.idle_member.errorgen.blocks[0].basis_element_labels
    planted = truth.idle_member.gpindices.start + lbls.index('XII')
    vt[planted] = 0.03
    truth.from_vector(vt)
    ds = simulate_data(truth, circuits, 1000, seed=1616, device=device)
    start = cloud_model()
    layout = SimpleForwardSimulator(start, device).create_layout(circuits, ds)
    K1 = len(start.op_keys) + 1
    n_par = sum(len(k.components) > 1 for k in start.op_keys)
    n_out = layout.num_elements // layout.num_rows
    G = torch.zeros((K1, start.dim, start.dim), dtype=torch.float64, device=device)
    shared = g_in_shared_memory(G, n_out)
    optin = getattr(torch.cuda.get_device_properties(device), 'shared_memory_per_block_optin',
                    None)
    log("cloudfit3: create_cloudnoise_circuits(3 qubits, maxL %s, maxhops 1, extra gate weight "
        "1, seed 3) on the card: %d circuits, depth up to %d, %d germs, in %.2f s; model %d "
        "parameters, K1 %d (%d parallel layers), d %d, %d outcomes; the op stack G is %d bytes "
        "in float64 against %s bytes of shared memory a block may opt in to: the kernel keeps "
        "it in %s memory"
        % (maxls[-1], len(circuits), max(c.depth for c in circuits), len(struct.ys), design_s,
           start.num_params, K1, n_par, start.dim, n_out, G.numel() * 8, optin,
           'shared' if shared else 'global'))
    if start.num_params != 534 or start.dim != 64 or shared:
        raise SystemExit("unexpected 3-qubit cloud model, or its op stack in shared memory")
    stages = {}
    kernel = hold_kernel_at_buckets(layout, start, device, 'cloudfit3', stages=stages)
    errs, kms, kplain, keinsum, kbound, shapes = kernel
    log("cloudfit3: kernel bwd_jacobian (two-stage route) at this layout's %d bucket shapes %s: "
        "max rel err f64 %.3e (tol 1e-12), f32 %.3e (tol 1e-5), bitwise between two launches; "
        "%.4f ms per Jacobian f64 (profiled in a fresh process: chain %.4f ms, tiles %.4f "
        "ms; the card's A.zero_() of the same blocks %.4f ms) against a bound of %.4f ms "
        "(%.1f%% of it; G read through L2, not counted); plain %.2f ms, einsum yardstick "
        "%.2f ms (%s)"
        % (len(shapes), shapes, errs[torch.float64], errs[torch.float32], kms,
           stages.get('chain', 0.0), stages.get('tiles', 0.0), stages.get('fill', 0.0), kbound,
           100 * kbound / kms, kplain, keinsum, card_name_and_limit()))
    if not (stages.get('chain', 0.0) > 0 and stages.get('tiles', 0.0) > 0):
        raise SystemExit("the stage profile recorded no chain or tile kernel")
    x = torch.as_tensor(vt, device=device)
    t0 = time.time()
    Tv = start.flat_tensors_jacobian_fn()(x)
    torch.cuda.synchronize()
    tv_s = time.time() - t0
    dTv = float((Tv - torch.func.jacfwd(start.flat_tensors_fn())(x)).abs().max())
    log("cloudfit3: Tv [%d x %d] by the leaves' jvp and the product rule on the card in %.3f s; "
        "against torch.func.jacfwd max |d| %.3e (tol 1e-12)" % (*Tv.shape, tv_s, dTv))
    if not dTv < 1e-12:
        raise SystemExit("the 3-qubit implicit model's Tv disagrees with jacfwd")
    del Tv
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bwd_jacobian_accumulate.launches = 0
    t0 = time.time()
    iters = []
    for name in ('chi2', 'logl'):
        result, objective = run_gst_fit_simple(ds, start, circuits, {'maxiter': LM_MAXITER},
                                               name, device=device)
        q = result.optimizer_specific_qtys
        iters.append(q['iterations'])
        log("cloudfit3: %s from %s: %d LM iterations, %.3f s, objective %.6f, jac_mode %s, %s"
            % (name, 'zero' if name == 'chi2' else 'the chi2 fit', q['iterations'],
               q['wall_s'], result.f, objective.jac_mode, q['msg']))
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = bwd_jacobian_accumulate.launches
    peak = torch.cuda.max_memory_allocated() / 1e6
    tdl_fit = two_delta_logl(start, ds, circuits, device=device)
    tdl_truth = two_delta_logl(truth, ds, circuits, device=device)
    k = ds.degrees_of_freedom(circuits) - start.num_params
    nsig = (tdl_fit - k) / np.sqrt(2 * k)
    rate = float(start.to_vector()[planted])
    log("cloudfit3: %d + %d LM iterations in %.3f s; kernel launches {'bwd_jacobian': %d}; "
        "2*DeltaLogL %.6f (the truth's %.6f), k %d, N_sigma %.4f; planted idle H_X on qubit 0 "
        "0.03, fitted %.6f; peak device memory %.1f MB"
        % (iters[0], iters[1], fit_s, launches, tdl_fit, tdl_truth, k, nsig, rate, peak))
    log("cloudfit3: %.1f ms per LM iteration; launches %d = %d buckets x %d Jacobians"
        % (1e3 * fit_s / sum(iters), launches, len(shapes), sum(iters)))
    # where one iteration's time goes: one J^T J / J^T f at the fitted point
    objective.jtj_jtf()
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        objective.jtj_jtf()
        torch.cuda.synchronize()
    wall = time.time() - t0
    kernels = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log("cloudfit3: profile of one jtj_jtf at the fit: wall %.1f ms (profiled), the card busy "
        "%.1f ms in %d launches; by kernel: %s"
        % (1e3 * wall, busy, sum(e.count for e in kernels), "; ".join(
            "%s %.2f ms x%d" % (e.key.split('<')[0].split('::')[-1][:48],
                                e.self_device_time_total / 1e3, e.count) for e in kernels[:10])))
    if launches == 0:
        raise SystemExit("the 3-qubit cloud-noise fit never launched the bwd_jacobian kernel")
    if launches != len(shapes) * sum(iters):
        raise SystemExit("the 3-qubit cloud-noise fit's kernel launches are not the buckets "
                         "times the LM iterations")
    if not (abs(rate - 0.03) < 0.01 and tdl_fit < tdl_truth + 10 and abs(nsig) < 10):
        raise SystemExit("the 3-qubit cloud-noise fit missed the planted rate or the optimum")
    return launches, kernel


def over_rotated(model, angle):
    """`model` with Gxpi2:0 and Gxpi2:1 followed by exp(-i angle/2 X) on
    their qubit: an over-rotation by `angle` rad."""
    import scipy.linalg
    from pygsti_tpu_torch.modelmembers.operations import FullTPOp
    from pygsti_tpu_torch.tools.optools import unitary_to_superop
    m = model.copy()
    rx = scipy.linalg.expm(-0.5j * angle * np.array([[0, 1], [1, 0]]))
    for q, u in ((0, np.kron(rx, np.eye(2))), (1, np.kron(np.eye(2), rx))):
        lbl = next(k for k in m.operations if k == ('Gxpi2', q))
        m.operations[lbl] = FullTPOp(np.real(unitary_to_superop(u, 'pp'))
                                     @ m.operations[lbl].dense())
    return m


def phase_statistics(mp, est, target, datagen, lists, builders, device):
    """Phase 21: the estimate's error bars and bad-fit handling at full
    width: phase 3's 'full' estimate's Hessians (Gauss-Newton through the
    kernel, exact by forward over reverse in chunks), the non-gauge space,
    the four projections, error bars of two gates' infidelities, linear
    response; a fit of drifting data (two over-rotations of opposite sign)
    with the bad-fit actions 'wildcard1d', 'wildcard' and 'Robust+'; the
    Fisher information by L.  Returns the kernel launches of the phase."""
    from pygsti_tpu_torch.objectivefns import objectivefns as objfns
    from pygsti_tpu_torch.objectivefns.wildcardbudget import WaterfillPlan, _WildcardObjective
    from pygsti_tpu_torch.ops.bwd_jacobian import (bwd_jacobian_accumulate,
                                                   bwd_jacobian_accumulate_plain)
    from pygsti_tpu_torch.protocols.confidenceregionfactory import ConfidenceRegionFactory
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                GSTInitialModel)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.models.nongauge import nongauge_and_gauge_spaces
    from pygsti_tpu_torch.tools.edesigntools import (calculate_fisher_information_matrices_by_L,
                                                     calculate_fisher_information_matrix,
                                                     calculate_fisher_information_per_circuit)
    from pygsti_tpu_torch.tools.optools import entanglement_infidelity
    import scipy.stats as st
    t_phase = time.time()
    launches = 0

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    # -- (a) the 'full' estimate's Hessians, projections and error bars ----
    bwd_jacobian_accumulate.launches = 0
    crf = est.create_confidence_region_factory()
    obj, t_obj = timed(crf.objective)
    model = crf.model
    v0 = model.to_vector()
    H_a, ta = timed(lambda: crf.compute_hessian(approximate=True))
    ka = bwd_jacobian_accumulate.launches
    with torch.no_grad():
        p = obj._fns['probs'](obj._v(None))
        h = obj.raw_objfn.hterms(p, *obj._data)
    _, t_gram = timed(lambda: obj.weighted_gram(h))
    _, t_grad = timed(obj.gradient)
    objfns.bwd_jacobian_accumulate = bwd_jacobian_accumulate_plain
    try:
        H_plain = obj.weighted_gram(h)
    finally:
        objfns.bwd_jacobian_accumulate = bwd_jacobian_accumulate
    rel_plain = float(np.max(np.abs(H_a - H_plain)) / np.max(np.abs(H_plain)))
    rng = np.random.RandomState(2110)
    eps = 1e-6
    fd_a = []
    for _ in range(4):
        u = rng.randn(len(v0))
        u /= np.linalg.norm(u)
        Ju = (obj.probs(v0 + eps * u) - obj.probs(v0 - eps * u)) / (2 * eps)
        quad = float(np.sum(h.cpu().numpy() * Ju ** 2))
        fd_a.append(abs(u @ H_a @ u - quad) / abs(quad))
    log("statistics: the objective (layout, data on the card) in %.3f s; approximate Hessian "
        "[%d x %d] (J^T diag(hterms) J through the kernel, %d launches) with the gradient in "
        "%.3f s the first time; warm, the weighted Gram %.4f s and the gradient %.4f s; against "
        "the plain version on the card max rel %.3e (tol 1e-12); u^T H u against sum h (J u)^2 "
        "with J u by central differences of the probabilities (h 1e-6) along 4 seeded "
        "directions: rel %s (tol 1e-6)"
        % (t_obj, H_a.shape[0], H_a.shape[1], ka, ta, t_gram, t_grad, rel_plain,
           ['%.2e' % x for x in fd_a]))
    if not (ka > 0 and rel_plain < 1e-12 and max(fd_a) < 1e-6):
        raise SystemExit("the approximate Hessian disagrees with its plain version or with "
                         "finite differences")
    crf_e = ConfidenceRegionFactory(est, device=device)
    torch.cuda.reset_peak_memory_stats()
    H_e, te = timed(lambda: crf_e.compute_hessian())
    peak_e = torch.cuda.max_memory_allocated() / 1e6
    sym = float(np.max(np.abs(H_e - H_e.T)) / np.max(np.abs(H_e)))
    fd_e = []
    for _ in range(4):
        u = rng.randn(len(v0))
        u /= np.linalg.norm(u)
        fd = (obj.gradient(v0 + eps * u) - obj.gradient(v0 - eps * u)) / (2 * eps)
        Hu = H_e @ u
        fd_e.append(float(np.max(np.abs(Hu - fd)) / np.max(np.abs(Hu))))
    log("statistics: exact Hessian (the Gram plus sum dterms d2p, forward over reverse of the "
        "scan in %d chunks of tangents) in %.3f s, peak device memory %.1f MB; asymmetry %.3e "
        "(tol 1e-9); H u against central differences of the gradient along 4 seeded directions:"
        " rel %s (tol 1e-6); exact against approximate max rel %.3e"
        % (crf_e.objective()._prob_hessian.chunks, te, peak_e, sym, ['%.2e' % x for x in fd_e],
           float(np.max(np.abs(H_e - H_a)) / np.max(np.abs(H_e)))))
    if not (sym < 1e-9 and max(fd_e) < 1e-6 and np.all(np.isfinite(H_e))):
        raise SystemExit("the exact Hessian is not symmetric or disagrees with finite "
                         "differences")
    (ng, g), tng = timed(lambda: nongauge_and_gauge_spaces(model, device=device))
    log("statistics: non-gauge dimension %d, gauge %d (the full gauge group on d %d: %d "
        "generators), in %.3f s" % (ng.shape[1], g.shape[1], model.dim, model.dim ** 2, tng))
    if ng.shape[1] != model.num_params - model.dim ** 2:
        raise SystemExit("unexpected non-gauge dimension %d" % ng.shape[1])
    for f in (crf, crf_e):
        for ptype in ('std', 'none', 'intrinsic error', 'optimal gate CIs'):
            inv, tp = timed(lambda: f.project_hessian(ptype))
            log("statistics: %s Hessian, projection %r in %.3f s: %d non-gauge parameters, "
                "finite %s" % ('approximate' if f is crf else 'exact', ptype, tp,
                               f.nNonGaugeParams, bool(np.all(np.isfinite(inv)))))
            if not np.all(np.isfinite(inv)):
                raise SystemExit("a projected inverse is not finite")
    bars = {}
    for lbl in (('Gxpi2', 0), ('Gcnot', 0, 1)):
        key = next(k for k in model.operations if k == lbl)

        def fn(m, key=key):
            return entanglement_infidelity(m.operations[key].dense(),
                                           target.operations[key].dense())
        for name, f in (('approximate', crf), ('exact', crf_e)):
            eb, tb = timed(lambda: f.view(95, hessian_projection='std').compute_uncertainty(fn))
            bars[(lbl, name)] = eb
            log("statistics: 95%% error bar of the entanglement infidelity of %s to the target "
                "from the %s Hessian: %.6e (infidelity %.6e), in %.2f s"
                % (key, name, eb, fn(model), tb))
        a, e = bars[(lbl, 'approximate')], bars[(lbl, 'exact')]
        if not (np.isfinite(a) and np.isfinite(e) and a > 0 and e > 0
                and abs(a - e) <= 0.2 * e):
            raise SystemExit("error bars not positive and finite, or exact and approximate "
                             "more than 20% apart")
    crf_lr = ConfidenceRegionFactory(est, device=device)
    crf_lr._exact = crf_e.hessian
    crf_lr.enable_linear_response_errorbars()
    key = next(k for k in model.operations if k == ('Gxpi2', 0))
    lr, tlr = timed(lambda: crf_lr.view(95).compute_uncertainty(
        lambda m: entanglement_infidelity(m.operations[key].dense(),
                                          target.operations[key].dense())))
    rel_lr = abs(lr - bars[(('Gxpi2', 0), 'exact')]) / bars[(('Gxpi2', 0), 'exact')]
    log("statistics: linear-response error bar of %s %.6e (CG on the non-gauge subspace, "
        "%.2f s) against the projected inverse's: rel %.3e (tol 1e-3)" % (key, lr, tlr, rel_lr))
    if not rel_lr < 1e-3:
        raise SystemExit("the linear-response error bar disagrees with the projected inverse's")
    launches += bwd_jacobian_accumulate.launches
    log("statistics: kernel launches over the Hessians and projections: {'bwd_jacobian': %d}"
        % bwd_jacobian_accumulate.launches)
    if bwd_jacobian_accumulate.launches == 0:
        raise SystemExit("the Hessians never launched the bwd_jacobian kernel")

    # -- (b) a fit that is really bad: drift between two over-rotations ----
    final = list(lists[-1])
    t0 = time.time()
    ds = simulate_data(over_rotated(datagen, 0.01), final, 500, seed=1234, device=device)
    ds_b = simulate_data(over_rotated(datagen, -0.01), final, 500, seed=1235, device=device)
    for c in final:
        ds.add_count_dict(c, dict(ds_b[c].counts))
    log("badfit: %d circuits, 500 shots from each of +0.01 and -0.01 rad over-rotations of "
        "Gxpi2:0 and Gxpi2:1, drawn on the card in %.2f s" % (len(ds), time.time() - t0))
    bwd_jacobian_accumulate.launches = 0
    gst = GateSetTomography(
        GSTInitialModel(model=target.copy()), gaugeopt_suite=None, objfn_builders=builders,
        optimizer={'maxiter': LM_MAXITER}, verbosity=0, device=device,
        badfit_options={'threshold': 2.0, 'actions': ('wildcard1d', 'wildcard', 'Robust+')})
    res, trun = timed(lambda: gst.run(ProtocolData(GateSetTomographyDesign(target, lists), ds),
                                      disable_checkpointing=True))
    bad = res.estimates['GateSetTomography']
    nsig = bad.misfit_sigma()
    stats = bad.parameters['badfit_stats']
    log("badfit: GateSetTomography.run in %.3f s (fit %.3f s); N_sigma %.4f (threshold 2); "
        "estimates %s; kernel launches {'bwd_jacobian': %d}"
        % (trun, bad.parameters['fit_time'], nsig, list(res.estimates),
           bwd_jacobian_accumulate.launches))
    for action, st_ in stats.items():
        log("badfit: action %r: %.3f s, objective evaluations %s"
            % (action, st_['seconds'], st_.get('evaluations', {})))
    launches += bwd_jacobian_accumulate.launches
    if not nsig > 2:
        raise SystemExit("the drifting data fit to N_sigma %.4f, not above 2" % nsig)
    mdl = bad.models['final iteration estimate']
    k = max(ds.degrees_of_freedom(final) - mdl.num_params, 1)
    bobj = objfns.TimeIndependentMDCObjectiveFunction(
        objfns.RawPoissonPicDeltaLogLFunction(), mdl, ds, final, device=device)
    b1 = stats['wildcard1d']['budget']
    thr1 = st.chi2.ppf(0.95, k)
    adj1 = _WildcardObjective(bobj, b1).raw_two_dlogl()
    bnm = stats['wildcard']['budget']
    thr = st.chi2.ppf(1 - 0.05, k)
    adjnm = _WildcardObjective(bobj, bnm).clipped_two_dlogl()
    log("badfit: wildcard1d alpha %.6e (budgets %s); adjusted 2DeltaLogL %.6f against the "
        "threshold %.6f; Nelder-Mead budget %s, adjusted 2DeltaLogL %.6f against %.6f"
        % (b1.alpha, ['%.3e' % x for x in b1.wildcard_vector], adj1, thr1,
           ['%.3e' % x for x in bnm.wildcard_vector], adjnm, thr))
    if not (b1.alpha > 0 and adj1 <= thr1 * (1 + 1e-6) and adjnm <= thr * (1 + 1e-6)):
        raise SystemExit("a wildcard budget does not bring 2DeltaLogL to its threshold")
    plans = [WaterfillPlan(bnm, bobj.layout.element_slices, bobj.layout.circuits, bobj.freqs,
                           dev) for dev in (device, 'cpu')]
    probs = bobj.probs()
    plans[0].update(probs, bnm.wildcard_vector, True)
    (pc, dc), tw = timed(lambda: plans[0].update(probs, bnm.wildcard_vector, True))
    (pp, dp), tcpu = timed(lambda: plans[1].update(probs, bnm.wildcard_vector, True))
    dw = max(float(torch.max(torch.abs(pc.cpu() - pp))), float(torch.max(torch.abs(dc.cpu() - dp))))
    log("badfit: one batched water-fill of %d circuits with dp/dW: %.4f s on the card (warm), "
        "%.4f s on the host's CPU; card against CPU max |d| %.3e (tol 1e-13)"
        % (len(final), tw, tcpu, dw))
    if not dw < 1e-13:
        raise SystemExit("the card's water-fill disagrees with the CPU's")
    rob = res.estimates.get('GateSetTomography.Robust+')
    if rob is None or 'weights' not in rob.parameters \
            or 'reoptimized_objfn_value' not in rob.parameters:
        raise SystemExit("the 'Robust+' estimate lacks its weights or its re-fit")
    log("badfit: 'Robust+': %d circuits reweighted; the re-fit's 2DeltaLogL on the scaled data "
        "%.6f" % (len(rob.parameters['weights']), rob.parameters['reoptimized_objfn_value']))

    # -- (c) Fisher information by L at the depolarized target --------------
    bwd_jacobian_accumulate.launches = 0
    maxls = [L for L in (1, 2, 4, 8, 16, 32, 64) if L <= MAXL]
    byL, tf = timed(lambda: calculate_fisher_information_matrices_by_L(
        datagen, lists, maxls, num_shots=1000, device=device))
    for L, F in byL.items():
        ev = np.linalg.eigvalsh((F + F.T) / 2)
        asym = float(np.max(np.abs(F - F.T)) / np.max(np.abs(F)))
        if not (asym < 1e-12 and ev.min() > -1e-10 * ev.max()):
            raise SystemExit("the Fisher information at L %d is not symmetric PSD" % L)
    some = final[:: len(final) // 50][:50]
    per = calculate_fisher_information_per_circuit(datagen, some, device=device)
    F50 = calculate_fisher_information_matrix(datagen, some, device=device)
    rel50 = float(np.max(np.abs(F50 - sum(per.values()))) / np.max(np.abs(F50)))
    log("fisher: calculate_fisher_information_matrices_by_L of the %d lists (%d circuits in "
        "the last, 1000 shots) in %.3f s, symmetric PSD; on 50 circuits the matrix against the "
        "sum of the per-circuit ones: rel %.3e (tol 1e-10); kernel launches "
        "{'bwd_jacobian': %d}" % (len(byL), len(final), tf, rel50,
                                  bwd_jacobian_accumulate.launches))
    launches += bwd_jacobian_accumulate.launches
    if not rel50 < 1e-10:
        raise SystemExit("the Fisher information disagrees with its per-circuit sum")
    log("phase 21: %.1f s of the script's wall time" % (time.time() - t_phase))
    return launches, bars


def num_buckets(layout, model, device):
    """How many depth buckets the blocked Jacobian of `layout` scans: the
    kernel's launches per LM iteration."""
    from pygsti_tpu_torch.objectivefns.objectivefns import bucket_plan
    n_out, d = layout.num_elements // layout.num_rows, model.dim
    NT = len(model.op_keys) * d * d + d + n_out * d
    return len(bucket_plan(layout, n_out, NT, device)[0])


def same_rows(a, b):
    """Whether two datasets hold the same circuits, outcome labels and
    counts, each in the same order."""
    return a.keys() == b.keys() and a.outcome_labels == b.outcome_labels and all(
        list(a[c].counts.items()) == list(b[c].counts.items()) for c in a.keys())


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def phase_data_io(mp, target, lists, ds, fitted, fit_value, nsigma, datagen, gx_bar95, device):
    """Phase 22: phase 3's dataset through the text format and the one-call
    driver, its results through a directory, the empty-data workflow, and
    the bootstrap: 4 full-width refits of resamples through the kernel,
    gauge-optimized, with the spread of Gxpi2:0's entanglement infidelity
    held against phase 21's Hessian error bar.  Runs in a temporary working
    directory, where the driver writes its checkpoints.  Returns the kernel
    launches of the driver's fit and of the bootstrap."""
    from pygsti_tpu_torch.drivers.bootstrap import (bootstrap_error_bars,
                                                    create_bootstrap_models,
                                                    gauge_optimize_models)
    from pygsti_tpu_torch.drivers.longsequence import run_long_sequence_gst
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.io.readers import (read_data_from_dir, read_dataset,
                                             read_results_from_dir)
    from pygsti_tpu_torch.io.writers import (fill_in_empty_dataset_with_fake_data,
                                             write_dataset, write_empty_protocol_data)
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    from pygsti_tpu_torch.protocols.estimate import misfit_sigma
    from pygsti_tpu_torch.protocols.gst import StandardGSTDesign
    from pygsti_tpu_torch.tools.optools import entanglement_infidelity
    import scipy.stats as st
    t_phase = time.time()
    final = list(lists[-1])
    maxlengths = [L for L in (1, 2, 4, 8, 16, 32, 64) if L <= MAXL]
    fids = (mp.prep_fiducials(), mp.meas_fiducials(), mp.germs(), maxlengths)
    old_cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix='chip_smoke_io_')
    os.chdir(work)
    try:
        # -- (1) the text round trip, (2) the default read --------------------
        path = os.path.join(work, 'dataset.txt')
        t0 = time.time()
        write_dataset(path, ds)
        t1 = time.time()
        back = read_dataset(path, record_zero_counts=True)
        t2 = time.time()
        dflt = read_dataset(path)
        t3 = time.time()
        log("io: write_dataset of %d circuits in %.3f s, %d bytes; read_dataset("
            "record_zero_counts=True) in %.3f s, the default read in %.3f s"
            % (len(ds), t1 - t0, os.path.getsize(path), t2 - t1, t3 - t2))
        if not same_rows(back, ds):
            raise SystemExit("the dataset file does not read back to the dataset written")
        dof_all, dof_dflt = ds.degrees_of_freedom(final), dflt.degrees_of_freedom(final)
        log("io: degrees of freedom over the final list: %d with every zero count recorded, "
            "%d read with the default record_zero_counts=False" % (dof_all, dof_dflt))
        if not dof_dflt <= dof_all or dflt.keys() != ds.keys():
            raise SystemExit("the default read gained degrees of freedom or lost circuits")

        # -- (3) the driver from the file -------------------------------------
        torch.cuda.synchronize()
        bwd_jacobian_accumulate.launches = 0
        t0 = time.time()
        res = run_long_sequence_gst(path, target, *fids, verbosity=0, device=device)
        torch.cuda.synchronize()
        driver_wall = time.time() - t0
        driver_launches = bwd_jacobian_accumulate.launches
        est = res.estimates['GateSetTomography']
        iters = log_stages('driver', est, lists)
        value, nsig = est.parameters['final_objfn_value'], est.misfit_sigma()
        fit_s = est.parameters['fit_time'] - est.parameters['profiler']['checkpoint writes']
        layout = SimpleForwardSimulator(fitted, device).create_layout(final)
        nb = num_buckets(layout, fitted, device)
        drv_model = est.models['final iteration estimate']
        dp = float(np.max(np.abs(
            SimpleForwardSimulator(drv_model, device).bulk_fill_probs(None, layout)
            - SimpleForwardSimulator(fitted, device).bulk_fill_probs(None, layout))))
        rel = abs(value - fit_value) / abs(fit_value)
        log("driver: run_long_sequence_gst(<file>, ..., %s) from LGST with its default "
            "regularization: %d LM iterations, fit %.3f s, the call %.3f s (LGST, fit, "
            "'stdgaugeopt', checkpoints); final 2*DeltaLogL %.6f against phase 3's %.6f: rel "
            "%.3e (tol 1e-3); N_sigma %.4f on %d degrees of freedom less the parameters "
            "(phase 3: %.4f on %d); 'final iteration estimate' probabilities of all %d circuits "
            "against phase 3's: max |dp| %.3e (tol 1e-4); kernel launches {'bwd_jacobian': %d} "
            "(%d buckets x %d iterations = %d)"
            % (maxlengths, iters, fit_s, driver_wall, value, fit_value, rel, nsig, dof_dflt,
               nsigma, dof_all, len(final), dp, driver_launches, nb, iters, nb * iters))
        if not (rel < 1e-3 and dp < 1e-4 and np.isfinite(nsig)):
            raise SystemExit("the driver's fit from the file missed phase 3's optimum")
        if driver_launches != nb * iters:
            raise SystemExit("the driver's kernel launches are not the buckets times the "
                             "LM iterations")

        # -- (4) the results directory ----------------------------------------
        rdir = os.path.join(work, 'results')
        t0 = time.time()
        res.write(rdir)
        t1 = time.time()
        rback = read_results_from_dir(rdir).for_protocol['GateSetTomography']
        t2 = time.time()
        best = rback.estimates['GateSetTomography']
        check = final[:: len(final) // 200][:200]
        check_layout = SimpleForwardSimulator(fitted, device).create_layout(check)
        dps = []
        for k in ('final iteration estimate', 'stdgaugeopt'):
            if not np.array_equal(best.models[k].to_vector(), est.models[k].to_vector()):
                raise SystemExit("the %r model does not read back bit for bit" % k)
            sims = [SimpleForwardSimulator(m.models[k], device) for m in (best, est)]
            dps.append(float(np.max(np.abs(sims[0].bulk_fill_probs(None, check_layout)
                                           - sims[1].bulk_fill_probs(None, check_layout)))))
        data_back = read_data_from_dir(rdir)
        log("results: write %.3f s, read_results_from_dir %.3f s, the directory %d bytes; "
            "parameters bit for bit, probabilities of %d circuits max |dp| %s (tol 1e-12), "
            "N_sigma %.6f read back %.6f"
            % (t1 - t0, t2 - t1, dir_bytes(rdir), len(check), ['%.1e' % x for x in dps], nsig,
               best.misfit_sigma()))
        if not (max(dps) <= 1e-12 and best.misfit_sigma() == nsig
                and same_rows(data_back.dataset, dflt)):
            raise SystemExit("the results directory does not read back to the results")

        # -- (5) the empty-data workflow -------------------------------------
        design = StandardGSTDesign(target, *fids)
        edir = os.path.join(work, 'empty')
        t0 = time.time()
        write_empty_protocol_data(edir, design)
        t1 = time.time()
        fill_in_empty_dataset_with_fake_data(os.path.join(edir, 'data', 'dataset.txt'), datagen,
                                             1000, seed=2211, device=device)
        t2 = time.time()
        filled = read_data_from_dir(edir)
        t3 = time.time()
        log("empty data: write_empty_protocol_data %.3f s; fill_in_empty_dataset_with_fake_data "
            "(1000 shots drawn from the card's probabilities) %.3f s; read_data_from_dir %.3f s; "
            "%d circuits" % (t1 - t0, t2 - t1, t3 - t2, len(filled.dataset)))
        if filled.dataset.keys() != design.all_circuits_needing_data or any(
                filled.dataset[c].total != 1000 for c in filled.dataset.keys()):
            raise SystemExit("the filled-in dataset is not the design's at 1000 shots")

        # -- (6) the bootstrap -----------------------------------------------
        n_boot, stats = 4, []
        torch.cuda.synchronize()
        bwd_jacobian_accumulate.launches = 0
        t0 = time.time()
        models, resamples = create_bootstrap_models(
            n_boot, ds, 'nonparametric', *fids, target_model=target, start_seed=2200,
            return_data=True, device=device, stats=stats)
        torch.cuda.synchronize()
        t1 = time.time()
        boot_launches = bwd_jacobian_accumulate.launches
        boot_iters = 0
        for i, (s, m, rs) in enumerate(zip(stats, models, resamples)):
            it = sum(r.optimizer_specific_qtys['iterations'] for rr in s['optimizer_results']
                     for r in rr)
            boot_iters += it
            v = s['optimizer_results'][-1][-1].chi2_k_distributed_qty
            k = max(rs.degrees_of_freedom(final) - m.num_params, 1)
            # A resample is drawn from the observed frequencies, which already
            # sit off the model by phase 3's misfit X: at its optimum the refit
            # keeps X, adds a chi2_k of its own draw and a cross term of
            # variance 4X, so 2DeltaLogL is near X + k with variance 4X + 2k,
            # and its N_sigma is near sqrt(k / 2), not near 0.
            z = (v - fit_value - k) / np.sqrt(4 * fit_value + 2 * k)
            log("bootstrap: refit %d (seed %d): %d LM iterations (%d launches), %.3f s with its "
                "resample; 2*DeltaLogL %.6f, N_sigma %.4f (sqrt(k/2) %.4f), against phase 3's "
                "misfit plus the resample's draw: z %.4f (tol |z| < 10)"
                % (i, 2200 + i, it, nb * it, s['seconds'], v, misfit_sigma(v, k),
                   np.sqrt(k / 2), z))
            if not abs(z) < 10:
                raise SystemExit("a bootstrap refit is far from its optimum: z %g" % z)
        gauged = gauge_optimize_models(models, target, device=device)
        t2 = time.time()
        key = next(k for k in target.operations if k == ('Gxpi2', 0))

        def infid(m):
            return entanglement_infidelity(m.operations[key].dense(),
                                           target.operations[key].dense())
        mean, std = bootstrap_error_bars(gauged, infid)
        sigma = gx_bar95 / np.sqrt(st.chi2.ppf(0.95, 1))
        log("bootstrap: %d refits in %.3f s (%d LM iterations, kernel launches {'bwd_jacobian': "
            "%d}, %d buckets x %d = %d), gauge_optimize_models %.3f s; entanglement infidelity "
            "of %s: mean %.6e, standard deviation %.6e against phase 21's Hessian sigma %.6e "
            "(its 95%% bar %.6e / %.4f): ratio %.3f (within a factor of 10)"
            % (n_boot, t1 - t0, boot_iters, boot_launches, nb, boot_iters, nb * boot_iters,
               t2 - t1, key, mean, std, sigma, gx_bar95, np.sqrt(st.chi2.ppf(0.95, 1)),
               std / sigma))
        if boot_launches != nb * boot_iters:
            raise SystemExit("the bootstrap's kernel launches are not the buckets times the LM "
                             "iterations")
        if not (np.isfinite(std) and std > 0 and 0.1 < std / sigma < 10):
            raise SystemExit("the bootstrap's spread is not within a factor of 10 of the "
                             "Hessian's")
    finally:
        os.chdir(old_cwd)
        shutil.rmtree(work, ignore_errors=True)
    log("phase 22: %.1f s of the script's wall time" % (time.time() - t_phase))
    return driver_launches, boot_launches


def rb_and_cloud3_phases(device):
    """Phases 18-20; returns the 3-qubit cloud fit's kernel launches."""
    t0 = time.time()
    phase_q3rb(device)
    t1 = time.time()
    phase_crb2(device)
    t2 = time.time()
    launches, _ = phase_cloudfit3(device)
    t3 = time.time()
    log("phases 18, 19 and 20: %.1f s, %.1f s and %.1f s of the script's wall time"
        % (t1 - t0, t2 - t1, t3 - t2))
    return launches


def implicit_phases(device):
    """Phases 15-17; returns the cloud-noise fit's kernel launches."""
    t0 = time.time()
    designs, _ = phase_cloud5(device)
    t1 = time.time()
    cloud_launches, _ = phase_cloudfit(device)
    t2 = time.time()
    phase_statevec(designs, device)
    t3 = time.time()
    log("phases 15, 16 and 17: %.1f s, %.1f s and %.1f s of the script's wall time"
        % (t1 - t0, t2 - t1, t3 - t2))
    return cloud_launches


SELECTION_SEED = 2026
SELECTION_MAXL = [1, 2, 4, 8, 16]


def phase_design_selection(datagen, device):
    """Phase 23: fiducials, germs and fiducial pairs selected for
    smq2Q_XYICNOT at full width on the card, then the selected design fitted
    through the kernel; returns the fit's kernel launches."""
    from pygsti_tpu_torch.algorithms import (fiducialpairreduction as fpr,
                                             fiducialselection as fs, germselection as gs)
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.drivers.longsequence import run_long_sequence_gst_base
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.modelpacks import smq2Q_XYICNOT as mp
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate

    t_phase = time.time()
    target = mp.target_model('full')
    if (target.num_params, len(target.operations)) != (1616, 6):
        raise SystemExit("unexpected smq2Q_XYICNOT 'full' model")
    # (1) fiducials, with find_fiducials' defaults
    t0 = time.time()
    prep, meas = fs.find_fiducials(target, verbosity=0, device=device)
    torch.cuda.synchronize()
    fid_s = time.time() - t0
    spans = [fs.compute_composite_fiducial_score(target, f, kind, device=device)
             for f, kind in ((prep, 'prep'), (meas, 'meas'))]
    n_cands = sum(5 ** L for L in range(5)) if len(target.operations) == 6 else None
    log("selection: find_fiducials (%s candidates of length <= 4) in %.2f s on the card: %d "
        "prep fiducials %s, %d measurement fiducials %s; spanned %d and %d of d^2 = 16, scores "
        "%.4f and %.4f" % (n_cands, fid_s, len(prep), [f.str for f in prep], len(meas),
                           [f.str for f in meas], spans[0][1], spans[1][1], spans[0][0],
                           spans[1][0]))
    if not (spans[0][1] == 16 and spans[1][1] == 16):
        raise SystemExit("the selected fiducials do not span the superoperator space")

    # (2) germs, with find_germs' defaults
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    germs = gs.find_germs(target, randomize=True, seed=SELECTION_SEED, verbosity=0,
                          device=device, stats=stats)
    torch.cuda.synchronize()
    germ_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e6
    rmodel = gs._randomized(target, 1e-2, SELECTION_SEED)     # as find_germs randomizes
    proj = gs._nongauge_projector(rmodel, device=device)
    n_target = stats['target_directions']
    score_card, n_card = gs._GermScorer(rmodel, proj, n_target, device, l1_penalty=1e-2)(germs)
    t0 = time.time()
    proj_cpu = gs._nongauge_projector(rmodel, device='cpu')
    score_cpu, n_cpu = gs._GermScorer(rmodel, proj_cpu, n_target, 'cpu', l1_penalty=1e-2)(germs)
    cpu_s = time.time() - t0
    rel = abs(score_card - score_cpu) / abs(score_cpu)
    log("selection: find_germs (greedy, 'allJac', pool {3: 'all upto'}): %d candidates, %d "
        "directions to cover, %d greedy steps, %d sets scored, %d germs in %.2f s on the card: "
        "Jacobian and twirl %.2f s, projector %.2f s, scoring (batched eigvalsh) %.2f s; the "
        "largest stack scored at once %.1f MB, peak device memory %.1f MB; germs %s"
        % (stats['candidates'], n_target, stats['greedy_steps'], stats['sets_scored'],
           len(germs), germ_s, stats['jacobian_twirl_s'], stats['projector_s'],
           stats['scoring_s'], stats['gram_stack_bytes'] / 1e6, peak, [g.str for g in germs]))
    log("selection: margins: %d candidates with an eigenvalue gap within 10x of eps 1e-6 "
        "(smallest gap at or above eps %.3e); the amplified count's nearest eigenvalue %.3f "
        "decades from its threshold 1e-10 x the largest; the selected set's score %.9g "
        "(%d/%d amplified) on the card, %.9g (%d/%d) recomputed on the host's CPU in %.2f s: "
        "rel %.3e (tol 1e-8)"
        % (stats['near_eps_gap_candidates'], stats['smallest_eig_gap'],
           stats['n_amp_margin_decades'], score_card, n_card, n_target, score_cpu, n_cpu,
           n_target, cpu_s, rel))
    if not (n_card >= n_target and n_cpu >= n_target and rel < 1e-8
            and stats['score'] < 1e6):
        raise SystemExit("the selected germs are not amplificationally complete, or the card's "
                         "score disagrees with the CPU's")

    # (3) fiducial-pair reduction of the pack's fiducials for these germs
    t0 = time.time()
    fpr_stats = {}
    pairs = fpr.find_sufficient_fiducial_pairs_per_germ(
        target, mp.prep_fiducials(), mp.meas_fiducials(), germs, seed=SELECTION_SEED,
        device=device, stats=fpr_stats)
    torch.cuda.synchronize()
    fpr_s = time.time() - t0
    # each germ's pairs reach the rank of all its pairs' sensitivities on
    # the model the search randomized (its own criterion)
    fmodel = fpr._randomized_for_fpr(target, SELECTION_SEED)
    short = []
    for g, (rows, pidx, n_amp, _) in zip(germs, fpr._sensitivities(
            fmodel, germs, mp.prep_fiducials(), mp.meas_fiducials(),
            gs._nongauge_projector(fmodel, device=device), device=device)):
        sel = [k for k, p in enumerate(pidx) if p in set(pairs[g])]
        if fpr._rank(rows[sel]) != n_amp or fpr._rank(rows) != n_amp:
            short.append(g.str)
    n_all = len(mp.prep_fiducials()) * len(mp.meas_fiducials())
    every = {g: [(i, j) for i in range(len(mp.prep_fiducials()))
                 for j in range(len(mp.meas_fiducials()))] for g in germs}
    t0 = time.time()
    amp = fpr.test_fiducial_pairs(pairs, target, mp.prep_fiducials(), mp.meas_fiducials(),
                                  germs, device=device)
    amp_all = fpr.test_fiducial_pairs(every, target, mp.prep_fiducials(), mp.meas_fiducials(),
                                      germs, device=device)
    test_s = time.time() - t0
    log("selection: find_sufficient_fiducial_pairs_per_germ in %.2f s: the sensitivities on the "
        "card, the greedy searches' SVDs on the host's CPU (priced at %.1f s in one process, so "
        "split over %d worker processes, started in %.2f s); pairs per germ %s of %d, each "
        "germ's pairs at the full rank of its sensitivities (short: %s); test_fiducial_pairs at "
        "the target: %d amplified parameters, every pair %d (%.2f s)"
        % (fpr_s, fpr_stats['predicted_s'], fpr_stats['workers'], fpr_stats['worker_start_s'],
           [len(pairs[g]) for g in germs], n_all, short, amp, amp_all, test_s))
    if short or not (0 < amp <= amp_all and all(0 < len(pairs[g]) <= n_all for g in germs)):
        raise SystemExit("a germ's reduced fiducial pairs miss directions all its pairs reach")

    # (4) the selected design, fitted through the kernel
    lists = create_lsgst_circuit_lists(target, mp.prep_fiducials(), mp.meas_fiducials(), germs,
                                       SELECTION_MAXL, fid_pairs=pairs)
    final = list(lists[-1])
    ds = simulate_data(datagen, final, 1000, seed=1234, device=device)
    layout = SimpleForwardSimulator(target, device).create_layout(final)
    errs, kms, kplain, _, kbound, shapes = hold_kernel_at_buckets(layout, target, device,
                                                                  'selection')
    log("selection: the selected design: lists %s, max depth %d; kernel bwd_jacobian at its %d "
        "bucket shapes %s: max rel err f64 %.3e (tol 1e-12), f32 %.3e (tol 1e-5); %.4f ms per "
        "Jacobian f64 against a bound of %.4f ms (%.1f%% of it; plain %.2f ms)"
        % ([len(l) for l in lists], max(c.depth for c in final), len(shapes), shapes,
           errs[torch.float64], errs[torch.float32], kms, kbound, 100 * kbound / kms, kplain))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            torch.cuda.synchronize()
            bwd_jacobian_accumulate.launches = 0
            t0 = time.time()
            res = run_long_sequence_gst_base(ds, target, lists, verbosity=0, device=device)
            torch.cuda.synchronize()
            fit_wall = time.time() - t0
            launches = bwd_jacobian_accumulate.launches
        finally:
            os.chdir(cwd)
    est = res.estimates['GateSetTomography']
    iters = log_stages('selection', est, lists)
    nsigma = est.misfit_sigma()
    fitted = est.models['final iteration estimate']
    log("selection: run_long_sequence_gst_base on the selected design (%d circuits, 1,000 shots "
        "of phase 3's data-generating model): %d LM iterations, the call %.2f s (fit %.2f s, "
        "'stdgaugeopt'); kernel launches {'bwd_jacobian': %d}; final 2*DeltaLogL %.6f, k %d, "
        "N_sigma %.4f; Frobenius distance of the fit to the data-generating model %.6g"
        % (len(final), iters, fit_wall, est.parameters['fit_time'], launches,
           est.parameters['final_objfn_value'], est.parameters['final_dof'], nsigma,
           fitted.frobeniusdist(datagen)))
    if launches == 0:
        raise SystemExit("the fit of the selected design never launched the bwd_jacobian kernel")
    if not (np.all(np.isfinite(fitted.to_vector())) and nsigma < 10):
        raise SystemExit("the fit of the selected design is not finite or far from the "
                         "statistical optimum: N_sigma %g" % nsigma)
    log("phase 23: %.1f s of the script's wall time (fiducials %.1f s, germs %.1f s, pairs "
        "%.1f s)" % (time.time() - t_phase, fid_s, germ_s, fpr_s))
    return launches


def phase_errgen_propagation():
    """Phase 24: bench.py bench[q10] through the port (host integer algebra)."""
    from pygsti_tpu_torch.circuits.circuit import Circuit
    from pygsti_tpu_torch.errorgenpropagation import ErrorGeneratorPropagator
    from pygsti_tpu_torch.tools.errgenproptools import bch_approximation
    t_phase = time.time()
    n10 = 10
    gate_errs = {'Gxpi2': {('H', 'Z'): 0.001, ('S', 'X'): 0.0005},
                 'Gypi2': {('H', 'X'): 0.001, ('S', 'Y'): 0.0005},
                 'Gcnot': {('S', 'ZZ'): 0.002, ('H', 'XX'): 0.001}}
    prop10 = ErrorGeneratorPropagator.from_errorgen_dict(gate_errs, n10, tuple(range(n10)))
    rng10 = np.random.RandomState(7)
    gates10 = []
    for dpt in range(40):
        if dpt % 2 == 0:
            for q in range(n10):
                gates10.append((['Gxpi2', 'Gypi2'][rng10.randint(2)], q))
        else:
            for q in range(rng10.randint(2), n10 - 1, 2):
                gates10.append(('Gcnot', q, q + 1))
    c10 = Circuit(gates10, tuple(range(n10)))
    t0 = time.time()
    errs10 = prop10.propagate_errorgens(c10)
    prop_wall = time.time() - t0
    items10 = list(errs10.items())
    half10 = len(items10) // 2
    t0 = time.time()
    bch10 = bch_approximation(dict(items10[:half10]), dict(items10[half10:]), n10, bch_order=2)
    bch_wall = time.time() - t0
    log("errgen: propagation through the %d-gate 10-qubit Clifford circuit: %.3f s (%.1f gates/s, "
        "%d generators); BCH order 2: %.3f s (%d terms)"
        % (len(gates10), prop_wall, len(gates10) / max(prop_wall, 1e-9), len(errs10), bch_wall,
           len(bch10)))
    if not (len(errs10) > 0 and len(bch10) >= len(errs10)
            and all(np.isfinite(v) for v in bch10.values())):
        raise SystemExit("error-generator propagation gave no finite generators")
    from pygsti_tpu_torch.tools.errgenpolytools import circuit_probability_polynomial
    t0 = time.time()
    poly10, labels10 = circuit_probability_polynomial(prop10, c10, '0' * n10)
    p10 = poly10.evaluate(np.array([errs10[l] for l in labels10]))
    log("errgen: circuit_probability_polynomial of the circuit's all-zeros outcome: %d terms "
        "over %d rates (order 2) in %.3f s; ideal %.6e, at the propagated rates %.6e"
        % (len(poly10), len(labels10), time.time() - t0, poly10.get((), 0.0), p10))
    if not (len(poly10) > len(labels10) and np.isfinite(p10) and 0 <= p10 <= 1):
        raise SystemExit("the 10-qubit probability polynomial is empty or not a probability")
    log("phase 24: %.1f s of the script's wall time" % (time.time() - t_phase))


MIRROR_STRENGTHS = {'Gu3': 0.003, 'Gcnot': 0.02}
TERM_CIRCUITS = 8740     # phase 3's maxL-16 list
VB_GATES = ['Gxpi2', 'Gypi2', 'Gxpi', 'Gzpi', 'Gypi', 'Gcnot']


def u3_gate(args):
    from pygsti_tpu_torch.processors.random_compilation import u3_unitary
    return u3_unitary(*(float(a) for a in args))


def mirror_test_circuits(rng):
    """Six u3-cx circuits: widths 2, 3 and 4 at depths 4 and 8, each layer
    a Haar-random U3 on every qubit then CNOTs on alternating neighbour
    pairs."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.circuits.circuit import Circuit
    from pygsti_tpu_torch.protocols.mirror_edesign import haar_random_u3
    out = []
    for w in (2, 3, 4):
        for depth in (4, 8):
            layers = []
            for d in range(depth):
                layers.append([haar_random_u3(q, rng) for q in range(w)])
                layers.append([Label('Gcnot', (q, q + 1)) for q in range(d % 2, w - 1, 2)])
            out.append(Circuit(layers, tuple(range(w))))
    return out


def circuit_superop(mdl, circuit, device):
    """The dense process matrix of `circuit` under an implicit model: the
    product of its layers' op-stack slots, on the card."""
    idx = [mdl.register_layer(l) for l in circuit.layertup]
    v = torch.as_tensor(mdl.to_vector(), dtype=torch.float64, device=device)
    ops = mdl.tensors_fn()(v).ops
    mx = torch.eye(ops.shape[-1], dtype=ops.dtype, device=device)
    for k in idx:
        mx = ops[k] @ mx
    return mx.cpu().numpy()


def phase_mirror(device):
    """Phase 25: mirror benchmarks at 4 qubits.  MCFE of six u3-cx circuits
    (180 mirror circuits simulated on the card, bootstrap), held to each
    circuit's exact process fidelity; a volumetric benchmark of periodic
    mirror circuits at widths 1-4 simulated on the card, its statistics,
    VB table and capability regions, op-less models' predictions; the
    weak CHP simulator on bench[q3]."""
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.circuits.circuit import Circuit
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.forwardsims.stabilizersim import StabilizerForwardSimulator
    from pygsti_tpu_torch.forwardsims.weakforwardsim import CHPForwardSimulator
    from pygsti_tpu_torch.models.modelconstruction import create_crosstalk_free_model
    from pygsti_tpu_torch.models.oplessmodel import TwirledGatesModel, TwirledLayersModel
    from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    from pygsti_tpu_torch.protocols.scarab import (calculate_mirror_benchmark_results,
                                                   mirror_benchmark)
    from pygsti_tpu_torch.protocols.vb import ByDepthSummaryStatistics, PeriodicMirrorCircuitDesign
    from pygsti_tpu_torch.protocols.vbdataframe import VBDataFrame
    from pygsti_tpu_torch.report import vbplot
    from pygsti_tpu_torch.tools import optools
    t_phase = time.time()

    # -- (a) MCFE of six u3-cx circuits --------------------------------------
    pspec = QubitProcessorSpec(4, ['Gu3', 'Gcnot'], geometry='line',
                               nonstd_gate_unitaries={'Gu3': u3_gate})
    mdl = create_crosstalk_free_model(pspec, depolarization_strengths=MIRROR_STRENGTHS)
    tests = mirror_test_circuits(np.random.RandomState(2026))
    t0 = time.time()
    design = mirror_benchmark(tests, num_mcs_per_circ=10, rand_state=np.random.RandomState(0))
    circuits = design.all_circuits_needing_data
    design_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    mdl.register_circuit_layers(circuits)
    reg_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    ds = simulate_data(mdl, circuits, 2000, seed=3, device=device)
    torch.cuda.synchronize()
    sim_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.time()
    vbdf = calculate_mirror_benchmark_results(tests, ProtocolData(design, ds), num_bootstraps=100,
                                              rand_state=np.random.RandomState(1))
    boot_s = time.time() - t0
    log("mirror: %d test circuits -> %d mirror circuits (depth up to %d) in %.2f s on the host; "
        "op-stack registration %.2f s (%d slots of d %d), simulate_data(2000 shots) on the card "
        "%.2f s (peak device memory %.2f GB), MCFE with 100 bootstraps %.2f s"
        % (len(tests), len(circuits), max(c.depth for c in circuits), design_s, reg_s,
           len(mdl.op_keys), mdl.dim, sim_s, peak_gb, boot_s))
    ideal = create_crosstalk_free_model(pspec, depolarization_strengths={
        g: 0.0 for g in MIRROR_STRENGTHS})
    # the exact process fidelity: the ideal circuit is unitary, so its
    # superoperator S_U is orthogonal and F_e = Tr(S_U^T S) / d^2 (the Choi
    # form of optools.entanglement_fidelity needs 64 GB at 4 qubits: it is
    # held to this one on the 2-qubit circuits' own 2-qubit model)
    pspec2 = QubitProcessorSpec(2, ['Gu3', 'Gcnot'], geometry='line',
                                nonstd_gate_unitaries={'Gu3': u3_gate})
    mdl2 = create_crosstalk_free_model(pspec2, depolarization_strengths=MIRROR_STRENGTHS)
    ideal2 = create_crosstalk_free_model(pspec2, depolarization_strengths={
        g: 0.0 for g in MIRROR_STRENGTHS})
    t = vbdf.table
    for i, c in enumerate(tests):
        S, U = circuit_superop(mdl, c, device), circuit_superop(ideal, c, device)
        exact = float(np.trace(U.T @ S)) / S.shape[0]
        check = ""
        if c.num_lines == 2:
            choi = optools.entanglement_fidelity(circuit_superop(mdl2, c, device),
                                                 circuit_superop(ideal2, c, device), 'pp')
            check = "; optools.entanglement_fidelity on the 2-qubit model %.12f" % choi
            if abs(choi - exact) > 1e-10:
                raise SystemExit("the trace form of the process fidelity disagrees with optools")
        est, std = t['process_fidelity'][i], t['process_fidelity_std'][i]
        log("mirror: width %d depth %2d: MCFE process fidelity %.5f +/- %.5f, exact %.5f "
            "(|diff| %.5f, bound 3 std + 0.02 = %.5f)%s"
            % (c.num_lines, c.depth // 2, est, std, exact, abs(est - exact), 3 * std + 0.02, check))
        if not (np.isfinite(est) and abs(est - exact) <= 3 * std + 0.02):
            raise SystemExit("MCFE missed the exact process fidelity of test circuit %d" % i)

    # -- (b) volumetric benchmark of periodic mirror circuits ------------------
    # each width's circuits run on a model of that many qubits, so that the
    # outcomes are bit strings of the circuit's width
    vpspec = QubitProcessorSpec(4, VB_GATES, geometry='line')
    strengths = {g: (0.02 if g == 'Gcnot' else 0.003) for g in VB_GATES}
    vmdls = {w: create_crosstalk_free_model(QubitProcessorSpec(w, VB_GATES, geometry='line'),
                                            depolarization_strengths=strengths)
             for w in (1, 2, 3, 4)}
    depths = [0, 4, 8, 16, 32]
    t0 = time.time()
    designs = {}
    for w in (1, 2, 3, 4):
        qs = tuple(range(w))
        germ = Circuit([[('Gxpi2', 0)]], (0,)) if w == 1 else \
            Circuit([[('Gxpi2', 0), ('Gypi2', 1)], [('Gcnot', 0, 1)]], qs)
        designs[w] = PeriodicMirrorCircuitDesign(vpspec, depths, 10, germ, qubit_labels=qs,
                                                 seed=2026 + w)
    vb_circuits = [c for d in designs.values() for c in d.all_circuits_needing_data]
    vb_ideals = [i for d in designs.values() for l in d.idealout_lists for i in l]
    vdesign_s = time.time() - t0
    stab = StabilizerForwardSimulator(vpspec)
    n_ideal = sum(stab.probability(c, ''.join(str(b) for b in i)) == 1.0
                  for c, i in zip(vb_circuits, vb_ideals))
    torch.cuda.synchronize()
    t0 = time.time()
    vds = {w: simulate_data(vmdls[w], d.all_circuits_needing_data, 1000, seed=4 + w,
                            device=device) for w, d in designs.items()}
    torch.cuda.synchronize()
    vsim_s = time.time() - t0
    dp = 0.0
    for w, d in designs.items():
        some = d.all_circuits_needing_data[::4][:13 if w < 4 else 11]
        card = SimpleForwardSimulator(vmdls[w], device)
        cpu = SimpleForwardSimulator(vmdls[w], 'cpu')
        dp = max(dp, float(np.max(np.abs(card.bulk_fill_probs(None, card.create_layout(some))
                                         - cpu.bulk_fill_probs(None, cpu.create_layout(some))))))
    t0 = time.time()
    rows = []
    for w, d in designs.items():
        res = ByDepthSummaryStatistics().run(ProtocolData(d, vds[w]))
        for depth in depths:
            for k, pol in enumerate(res.statistics['polarization'][depth]):
                rows.append({'Depth': depth, 'Width': w, 'polarization': pol,
                             'success_probabilities': res.statistics['success_probabilities'][depth][k],
                             'total_counts': res.statistics['total_counts'][depth][k]})
    vb = VBDataFrame.from_benchmarking_data(rows)
    means = vb.vb_data('polarization', 'mean', lower_cutoff=-np.inf)
    regions = vb.capability_regions('polarization', threshold=1 / np.e)
    analysis_s = time.time() - t0
    page, page_bytes, page_s = written(text_writer(
        vbplot.volumetric_plot_html(means, title='VB') + vbplot.capability_region_plot_html(vb)),
        'vb.html')
    shown = sum(('Depth=%s Width=%s: %.3f' % (d, w, v)) in page for (d, w), v in means.items())
    log("vb: volumetric and capability-region plots written in %.3f s, %d bytes; %d of the %d "
        "mean polarizations shown" % (page_s, page_bytes, shown, len(means)))
    if shown != len(means):
        raise SystemExit("vb: the plot lacks the phase's mean polarizations")
    log("vb: %d periodic mirror circuits (widths 1-4, depths %s, 10 each; depth up to %d) in "
        "%.2f s on the host; the stabilizer simulator gives %d of them their ideal outcome with "
        "probability 1; simulate_data(1000 shots) on the card %.2f s; card vs CPU on %d circuits "
        "max |dp| %.3e (tol 1e-10); statistics, VB table and capability regions %.2f s"
        % (len(vb_circuits), depths, max(c.depth for c in vb_circuits), vdesign_s, n_ideal,
           vsim_s, 50, dp, analysis_s))
    bad = []
    for w in (1, 2, 3, 4):
        line = []
        for k, depth in enumerate(depths):
            pols = np.asarray(vb.table['polarization'][(vb.table['Width'] == w)
                                                       & (vb.table['Depth'] == depth)], float)
            se = pols.std(ddof=1) / np.sqrt(len(pols))
            line.append("%d: %.4f +/- %.4f [%d]" % (depth, means[depth, w], se,
                                                   regions.get((depth, w), -1)))
            if k:
                prev = np.asarray(vb.table['polarization'][(vb.table['Width'] == w)
                                                           & (vb.table['Depth'] == depths[k - 1])],
                                  float)
                se2 = np.hypot(se, prev.std(ddof=1) / np.sqrt(len(prev)))
                if means[depth, w] - means[depths[k - 1], w] > 3 * se2:
                    bad.append((w, depth))
        log("vb: width %d mean polarization by depth (standard error) [capability]: %s"
            % (w, "; ".join(line)))
    if not (n_ideal == len(vb_circuits) and dp < 1e-10 and not bad):
        raise SystemExit("VB: ideal outcomes, card vs CPU or monotone polarization failed: %s"
                         % (bad,))

    # -- (c) op-less models on the VB circuits --------------------------------
    rates = {'gates': {g: p * (3 / 4 if g != 'Gcnot' else 15 / 16) for g, p in strengths.items()},
             'readout': {}}
    sps = np.array([vds[c.num_lines][c].counts.get((''.join(str(b) for b in i),), 0)
                    / vds[c.num_lines][c].total for c, i in zip(vb_circuits, vb_ideals)])
    for cls in (TwirledLayersModel, TwirledGatesModel):
        om = cls(rates, 4, idle_name=None)
        pred = np.array([om.probabilities(c)[('success',)] for c in vb_circuits])
        worst = 0.0
        for c in vb_circuits[::20]:
            cache = om._circuit_cache(c)
            an = om._success_dprob(c, None, cache)
            v0 = om.to_vector().copy()
            fd = np.empty_like(an)
            for j in range(len(v0)):
                vp, vm = v0.copy(), v0.copy()
                vp[j] += 1e-6
                vm[j] -= 1e-6
                om.from_vector(vp)
                up = om._success_prob(c, cache)
                om.from_vector(vm)
                fd[j] = (up - om._success_prob(c, cache)) / 2e-6
            om.from_vector(v0)
            worst = max(worst, float(np.abs(an - fd).max()))
        by_w = ["width %d: predicted %.4f, measured %.4f" % (
            w, pred[[c.num_lines == w for c in vb_circuits]].mean(),
            sps[[c.num_lines == w for c in vb_circuits]].mean()) for w in (1, 2, 3, 4)]
        log("vb: %s success probabilities (mean over depths): %s; analytic dprobs vs central "
            "differences max |diff| %.3e (tol 1e-6)" % (cls.__name__, "; ".join(by_w), worst))
        if not (np.all(np.isfinite(pred)) and worst < 1e-6):
            raise SystemExit("op-less model %s: bad predictions or derivatives" % cls.__name__)

    # -- (d) the weak CHP simulator on bench[q3] ---------------------------------
    pspec3 = QubitProcessorSpec(3, CLOUD_GATES, geometry='line')
    circs3, ideals3 = bench_q3_circuits(pspec3)
    t0 = time.time()
    chp = CHPForwardSimulator(shots=100, pspec=pspec3, base_seed=0)
    n_all = sum(chp.probs(c).get((''.join(str(b) for b in i),), 0.0) == 1.0
                for c, i in zip(circs3, ideals3))
    log("weak: CHPForwardSimulator(100 shots) on bench[q3]'s %d circuits noiselessly: %d give "
        "every shot to the ideal outcome (%.2f s on the host)" % (len(circs3), n_all,
                                                                   time.time() - t0))
    if n_all != len(circs3):
        raise SystemExit("the weak simulator missed ideal outcomes")
    log("phase 25: %.1f s of the script's wall time (registration %.2f s, simulation %.2f + %.2f s, "
        "MCFE bootstrap %.2f s, VB analysis %.2f s; %s)"
        % (time.time() - t_phase, reg_s, sim_s, vsim_s, boot_s, analysis_s, card_name_and_limit()))


def phase_term_simulator(lists, device):
    """Phase 26: the Taylor-term simulator at 2 qubits: smq2Q_XYICNOT 'H+s'
    (240 parameters) moved by 0.001 randn, phase 3's maxL-16 list, the
    order-2 coefficients built on the card and evaluated there, held to the
    dense simulator, to themselves at half the rates, to central
    differences and to the CPU path."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.forwardsims.termforwardsim import TermForwardSimulator, TermCoefficients
    from pygsti_tpu_torch.modelpacks import smq2Q_XYICNOT as mp
    t_phase = time.time()
    circuits = list(lists[4])
    model = mp.target_model('H+s')
    v0 = model.to_vector()
    noise = np.random.RandomState(3).randn(model.num_params) * 0.001
    model.from_vector(v0 + noise)
    P = model.num_params
    if len(circuits) != TERM_CIRCUITS or P != 240:
        raise SystemExit("unexpected term-simulator workload: %d circuits, %d parameters"
                         % (len(circuits), P))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sim = TermForwardSimulator(model, max_order=2, device=device)
    stats = {}
    co = sim.bulk_coefficients(circuits, stats=stats)
    build_s = stats['seconds']
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # (1) probability conservation of every circuit's polynomials
    d0 = float((co.c0.sum(1) - 1).abs().max())
    d1 = float(co.c1.sum(1).abs().max())
    d2 = float(co.c2.sum(1).abs().max())
    # (2) against the dense simulator, by depth; (3) at half the rates
    dense = SimpleForwardSimulator(model, device)
    layout = dense.create_layout(circuits)
    torch.cuda.synchronize()
    t0 = time.time()
    pd = dense.bulk_fill_probs(None, layout)
    dense_s = time.time() - t0
    col = {o: k for k, o in enumerate(co.outcomes)}

    def dense_matrix(flat):
        out = np.empty((len(circuits), len(co.outcomes)))
        for i in range(len(circuits)):
            sl = layout.element_slices[i]
            for k, o in enumerate(layout.outcomes[i]):
                out[i, col[o[-1]]] = flat[sl.start + k]
        return out

    v = torch.as_tensor(model.to_vector(), dtype=torch.float64, device=device)
    torch.cuda.synchronize()
    t0 = time.time()
    pt = co.probs(v)
    torch.cuda.synchronize()
    probs_s = time.time() - t0
    t0 = time.time()
    dpt = co.dprobs(v)
    torch.cuda.synchronize()
    dprobs_s = time.time() - t0
    diff = np.abs(pt.cpu().numpy() - dense_matrix(pd)).max(axis=1)
    depths = np.array([c.depth for c in circuits])
    by_depth = {int(dd): float(diff[depths == dd].max()) for dd in sorted(set(depths))}
    half = mp.target_model('H+s')
    half.from_vector(v0 + noise / 2)
    ph = SimpleForwardSimulator(half, device).bulk_fill_probs(None, layout)
    diff_half = np.abs(co.probs(half.to_vector()).cpu().numpy() - dense_matrix(ph)).max()
    ratio = diff.max() / diff_half
    # (4) dprobs against central differences of the term probabilities
    sub = TermCoefficients(circuits[:200], co.outcomes, co.c0[:200], co.c1[:200], co.c2[:200], P)
    dsub = sub.dprobs(v)
    fd = torch.empty_like(dsub)
    eye = torch.eye(P, dtype=torch.float64, device=device)
    for k in range(P):
        fd[..., k] = (sub.probs(v + 1e-6 * eye[k]) - sub.probs(v - 1e-6 * eye[k])) / 2e-6
    dfd = float((dsub - fd).abs().max())
    dall = float((dpt[:200] - dsub).abs().max())
    # (5) the card's coefficients against the CPU path on 100 circuits
    pick = list(range(0, len(circuits), len(circuits) // 100))[:100]
    t0 = time.time()
    cpu = TermForwardSimulator(model, max_order=2, device='cpu').bulk_coefficients(
        [circuits[i] for i in pick])
    cpu_s = time.time() - t0
    at = torch.as_tensor(pick, device=device)
    rel = 0.0
    for a, b in ((co.c0[at], cpu.c0), (co.c1[at], cpu.c1), (co.c2[at], cpu.c2)):
        b = b.to(device)
        scale = torch.clamp(b.abs().flatten(1).max(dim=1).values, min=1.0)
        rel = max(rel, float(((a - b).abs().flatten(1).max(dim=1).values / scale).max()))
    log("term: smq2Q_XYICNOT 'H+s' (%d parameters) moved by 0.001 randn (seed 3); %d circuits "
        "(maxL 16, depth up to %d); order-2 coefficients built on the card in %.2f s (host "
        "programs %.2f s; %d buckets, %d chunks; c2 %.2f GB; peak device memory %.2f GB); "
        "probabilities at a new vector %.4f s, dprobs %.4f s; the dense forward simulator %.3f s "
        "for the same circuits (%s)"
        % (P, len(circuits), depths.max(), build_s, stats['seconds_host'], stats['buckets'],
           stats['chunks'], co.c2.numel() * 8 / 1e9, peak_gb, probs_s, dprobs_s, dense_s,
           card_name_and_limit()))
    log("term: outcome sums: constant within %.3e of 1, order 1 %.3e, order 2 %.3e (tol 1e-10); "
        "max |p_term - p_dense| by depth %s (tol 1e-3); at half the rates %.3e (ratio %.2f, "
        "band 5-12); dprobs vs central differences (step 1e-6, 200 circuits, %d parameters) "
        "%.3e (tol 1e-7), 200 vs all %.3e; card vs CPU coefficients on %d circuits rel %.3e "
        "(tol 1e-12; the CPU path %.2f s)"
        % (d0, d1, d2, by_depth, diff_half, ratio, P, dfd, dall, len(pick), rel, cpu_s))
    if not (d0 < 1e-10 and d1 < 1e-10 and d2 < 1e-10 and diff.max() < 1e-3 and 5 < ratio < 12
            and dfd < 1e-7 and dall < 1e-12 and rel < 1e-12 and peak_gb < 40):
        raise SystemExit("the Taylor-term simulator failed a check")
    log("phase 26: %.1f s of the script's wall time" % (time.time() - t_phase))


TD_TIMES = 10            # phase 27: timestamps 0..9
TD_SHOTS = 100           # shots per circuit per timestamp (cell 1's 1,000 split in time)
TD_LAST_ANGLE = 0.02     # Gxpi2:0's over-rotation at the last timestamp, rad
DRIFT_T = 1000           # phase 28: single-shot timestamps per circuit
DRIFT_LAST_ANGLE = 0.2   # Gxpi2:0's over-rotation at the last of them, rad
DRIFT_CIRCUITS = 3527    # cell 1's maxL-4 list


def drifting_model(base_model, rate):
    """`base_model` with Gxpi2:0 a LinearTimeDriftOp: its FullTPOp over the
    base's dense Gxpi2:0, times exp(t L) for an 'H' generator in 'pp' on d
    16 (15 rates) whose X-on-qubit-0 rate is `rate` (the over-rotation at
    time t is rate * t rad)."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.modelmembers import operations as ops
    model = base_model.copy()
    key = Label('Gxpi2', 0)
    model.operations[key] = ops.LinearTimeDriftOp(
        ops.FullTPOp(model.operations[key].dense()),
        ops.build_lindblad_errorgen('pp', 'H', dim=16, initial_coeffs={('H', 'XI'): rate}))
    return model


def time_resolved_probs(model, circuits, times, device):
    """(layout, probabilities [len(times), n_circuits, n_outcomes]) of
    `model` at each time, on the card."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    sim = SimpleForwardSimulator(model, device)
    layout = sim.create_layout(circuits)
    probs = sim.probs_fn(layout)
    v = torch.as_tensor(model.to_vector(), dtype=torch.float64, device=device)
    with torch.no_grad():
        P = torch.stack([probs(v, float(t)) for t in times])
    return layout, P.reshape(len(times), len(circuits), -1)


def draw_outcomes(P, shots, seed):
    """Counts [T, C, n_out] of `shots` multinomial draws per (time,
    circuit) from probabilities P [T, C, n_out], on the card from a seeded
    torch.Generator."""
    gen = torch.Generator(device=P.device).manual_seed(seed)
    p = torch.clamp(P, min=0.0).reshape(-1, P.shape[-1])
    idx = torch.multinomial(p / p.sum(dim=1, keepdim=True), shots, replacement=True,
                            generator=gen)
    counts = torch.zeros_like(p, dtype=torch.int64).scatter_add_(
        1, idx, torch.ones_like(idx))
    return counts.reshape(P.shape)


def phase_time_resolved_fit(mp, lists, device):
    """Phase 27: smq2Q_XYICNOT 'full TP' depolarized 0.01 (cell 1's
    data-generating model) whose Gxpi2:0 drifts linearly in time (one
    planted H rate on X of qubit 0, 0.02 rad at the last of 10 timestamps),
    cell 1's 13,958 circuits at 100 shots per timestamp drawn on the card,
    fitted from the drift-free target by SimplerLMOptimizer through
    TimeDependentPoissonPicLogLFunction; the kernel held at the fit's
    buckets with G(t = 9).  Returns the fit's kernel launches."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.data.dataset import DataSet
    from pygsti_tpu_torch.objectivefns.timedep import TimeDependentPoissonPicLogLFunction
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    from pygsti_tpu_torch.optimize.simplerlm import SimplerLMOptimizer
    t_phase = time.time()
    circuits = list(lists[-1])
    times = [float(t) for t in range(TD_TIMES)]
    rate = TD_LAST_ANGLE / times[-1]
    truth = drifting_model(mp.target_model('full TP').depolarize(op_noise=0.01,
                                                                 spam_noise=0.01), rate)
    torch.cuda.synchronize()
    t0 = time.time()
    layout, P = time_resolved_probs(truth, circuits, times, device)
    counts = draw_outcomes(P, TD_SHOTS, 1234).cpu().numpy()
    t1 = time.time()
    ds = DataSet()
    for i, c in enumerate(circuits):
        outs = layout.outcomes[i]
        ds.add_raw_series_data(c, [o for _ in times for o in outs],
                               [t for t in times for _ in outs], counts[:, i].ravel().tolist())
    t2 = time.time()
    log("time-resolved fit: %d circuits x %d timestamps x %d shots drawn on the card in %.3f s "
        "(seed 1234), dataset built in %.3f s; planted H_XI rate %.6g per unit time"
        % (len(circuits), len(times), TD_SHOTS, t1 - t0, t2 - t1, rate))
    model = drifting_model(mp.target_model('full TP'), 0.0)
    obj = TimeDependentPoissonPicLogLFunction(model, ds, circuits, device=device)
    P_params = model.num_params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bwd_jacobian_accumulate.launches = 0
    t0 = time.time()
    result = SimplerLMOptimizer(maxiter=LM_MAXITER).run(obj, printer=0)
    fit_s = time.time() - t0      # ends in the loop's read of its result
    launches = bwd_jacobian_accumulate.launches
    peak = torch.cuda.max_memory_allocated() / 1e6
    iters = result.optimizer_specific_qtys['iterations']
    fitted = model.operations[Label('Gxpi2', 0)].drift_errorgen.to_vector()
    planted = truth.operations[Label('Gxpi2', 0)].drift_errorgen.to_vector()
    two_dlogl = obj.chi2k_distributed_qty(obj.fn(result.x))
    k = obj.num_elements - len(circuits) * len(times) - P_params
    nsigma = (two_dlogl - k) / np.sqrt(2 * k)
    # at 100 shots per (circuit, time) many outcomes expect about one count,
    # where 2DeltaLogL at the truth exceeds its asymptotic chi2 mean: its
    # exact mean, each element's count binomial at the truth's probability,
    # is the reference the fit is held to, less the P the fit takes
    truth_two_dlogl = obj.chi2k_distributed_qty(obj.fn(truth.to_vector()))
    expected = expected_two_dlogl(obj.probs(truth.to_vector()), obj.total_counts, device)
    z = (two_dlogl - (expected - P_params)) / np.sqrt(2 * k)
    log("time-resolved fit: %d parameters (15 drift rates), %d elements, %d buckets per time; "
        "%d LM iterations in %.3f s (%.1f ms each), exit '%s'; 2DeltaLogL %.6f, k %d, N_sigma "
        "%.4f; at the truth on these data %.6f, its exact mean over draws %.3f (%.3f above "
        "rows x (outcomes - 1)), z = (2DeltaLogL - (mean - P)) / sqrt(2k) = %.4f; kernel "
        "launches %d (times x buckets x Jacobians = %d x %d x %d); peak %.1f MB"
        % (P_params, obj.num_elements, obj.num_buckets // len(times), iters, fit_s,
           1e3 * fit_s / max(iters, 1), result.optimizer_specific_qtys['msg'], two_dlogl, k,
           nsigma, truth_two_dlogl, expected, expected - (k + P_params), z, launches,
           len(times), obj.num_buckets // len(times), iters, peak))
    labels = [str(l) for l in model.operations[Label('Gxpi2', 0)].drift_errorgen
              .errorgen_coefficient_labels()]
    log("time-resolved fit: fitted H rates %s; planted %s; norms %.6g fitted, %.6g planted "
        "(%.2f%% off)" % (", ".join("%s %.3e" % lv for lv in zip(labels, fitted)),
                          ", ".join("%s %.3e" % lv for lv in zip(labels, planted) if lv[1]),
                          np.linalg.norm(fitted), np.linalg.norm(planted),
                          100 * abs(np.linalg.norm(fitted) / np.linalg.norm(planted) - 1)))
    if launches != obj.num_buckets * iters:
        raise SystemExit("time-resolved fit: %d launches, not times x buckets x Jacobians"
                         % launches)
    if not abs(np.linalg.norm(fitted) / np.linalg.norm(planted) - 1) < 0.1:
        raise SystemExit("time-resolved fit: the fitted drift rates' norm is not within 10% "
                         "of the planted rate")
    if not (np.isfinite(nsigma) and np.isfinite(z) and abs(z) < 10):
        raise SystemExit("time-resolved fit: z %g (N_sigma %g)" % (z, nsigma))
    # one jtj_jtf on the card against the CPU path, on the first list's
    # circuits (the CPU's blocked Jacobian at full width and 10 times is
    # minutes of this host's time)
    small = list(lists[0])
    out = [TimeDependentPoissonPicLogLFunction(model, ds, small, device=dev).jtj_jtf(result.x)
           for dev in (device, 'cpu')]
    rel = max(float(np.max(np.abs(a - b)) / np.max(np.abs(b))) for a, b in zip(*out))
    log("time-resolved fit: lsvec/JTJ/JTf on the card vs the CPU path (%d circuits x %d "
        "times): max rel diff %.3e (tol 1e-12)" % (len(small), len(times), rel))
    if not rel < 1e-12:
        raise SystemExit("time-resolved fit: the card's jtj_jtf disagrees with the CPU path")
    errs, ms, plain_ms, einsum_ms, bound_ms, shapes = hold_kernel_at_buckets(
        layout, model, device, 'time-resolved fit (G at t = %g)' % times[-1], at_time=times[-1])
    log("time-resolved fit: the kernel at %d bucket shapes %s with G(t = %g): rel err f64 "
        "%.3e, f32 %.3e; %.4f ms per Jacobian (bound %.4f ms), plain %.3f ms, einsum %.3f ms; "
        "phase %.1f s"
        % (len(shapes), shapes, times[-1], errs[torch.float64], errs[torch.float32], ms,
           bound_ms, plain_ms, einsum_ms, time.time() - t_phase))
    return launches


def expected_two_dlogl(probs, totals, device, chunk=1 << 16):
    """The mean of the Poisson-picture 2DeltaLogL over draws at
    probabilities `probs` (each element's count binomial of its total),
    summed exactly over the counts 0..total, on the card."""
    from pygsti_tpu_torch.objectivefns.objectivefns import RawPoissonPicDeltaLogLFunction
    raw = RawPoissonPicDeltaLogLFunction()
    p = torch.clamp(torch.as_tensor(probs, dtype=torch.float64, device=device), 0.0, 1.0)
    N = torch.as_tensor(totals, dtype=torch.float64, device=device)
    n = torch.arange(int(N.max()) + 1, dtype=torch.float64, device=device)
    total = 0.0
    for s in range(0, p.shape[0], chunk):
        pc, Nc = p[s:s + chunk, None], N[s:s + chunk, None]
        valid = n[None, :] <= Nc
        nn = torch.where(valid, n[None, :], 0.0)
        logpmf = (torch.lgamma(Nc + 1) - torch.lgamma(nn + 1) - torch.lgamma(Nc - nn + 1)
                  + torch.xlogy(nn, pc) + torch.xlogy(Nc - nn, 1 - pc))
        pmf = torch.where(valid, torch.exp(logpmf), 0.0)
        terms = raw.terms(pc.expand_as(nn), nn, Nc.expand_as(nn), nn / Nc)
        total += float((pmf * torch.where(valid, terms, 0.0)).sum())
    return raw.chi2k_distributed_qty(total)


def contains_gxpi2_0(circuit):
    from pygsti_tpu_torch.baseobjs.label import Label
    return any(comp == Label('Gxpi2', 0) for layer in circuit.layertup
               for comp in layer.components)


def drift_data(model, circuits, seed, device):
    """(DataSet of DRIFT_T single shots per circuit at times 0..T-1, the
    two halves' aggregated DataSets, the exact probabilities [T, C, n_out],
    seconds of the draw and of the build), drawn on the card."""
    from pygsti_tpu_torch.data.dataset import DataSet
    times = np.arange(DRIFT_T, dtype=float)
    torch.cuda.synchronize()
    t0 = time.time()
    layout, P = time_resolved_probs(model, circuits, times, device)
    shots = torch.argmax(draw_outcomes(P, 1, seed), dim=-1).cpu().numpy()   # [T, C]
    t1 = time.time()
    if any(list(outs) != sorted(outs) for outs in layout.outcomes):
        raise SystemExit("drift: a circuit's outcomes are not in the analyzer's (sorted) order")
    ds, halves = DataSet(), (DataSet(), DataSet())
    for i, c in enumerate(circuits):
        outs = layout.outcomes[i]
        ds.add_raw_series_data(c, [outs[k] for k in shots[:, i]], times)
        for half, sl in zip(halves, (slice(0, DRIFT_T // 2), slice(DRIFT_T // 2, None))):
            n = np.bincount(shots[sl, i], minlength=len(outs))
            half.add_count_dict(c, {o: int(x) for o, x in zip(outs, n)})
    t2 = time.time()
    return ds, halves, P, t1 - t0, t2 - t1


def phase_drift_detection(mp, lists, device):
    """Phase 28 (Proctor et al., Nat. Commun. 11, 5396 (2020)): the drifting
    model of phase 27 with Gxpi2:0's over-rotation ramping 0 -> 0.2 rad over
    1,000 single-shot timestamps of cell 1's maxL-4 circuits (3.53 M shots
    drawn on the card); StabilityAnalysis with its 'auto' tests, then
    'filter' characterization of every circuit and 'mle' of the five of
    largest power; DataComparator on the halves split at t = 500; the same
    on data of the same shape from the static model (seed 1235)."""
    from pygsti_tpu_torch.data.datacomparator import DataComparator
    from pygsti_tpu_torch.extras.drift import signal
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    from pygsti_tpu_torch.protocols.stability import StabilityAnalysis, StabilityAnalysisDesign
    from pygsti_tpu_torch.report.factory import create_drift_report
    t_phase = time.time()
    circuits = list(lists[2])
    if len(circuits) != DRIFT_CIRCUITS:
        raise SystemExit("unexpected drift design: %d circuits" % len(circuits))
    datagen = mp.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01)
    runs = {}
    for tag, rate, seed in (('drifting', DRIFT_LAST_ANGLE / (DRIFT_T - 1), 1234),
                            ('static', 0.0, 1235)):
        ds, halves, P, draw_s, build_s = drift_data(drifting_model(datagen, rate), circuits,
                                                     seed, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = StabilityAnalysis(device=device).run(
            ProtocolData(StabilityAnalysisDesign(circuits), ds))
        run_s = time.time() - t0
        an = res.stabilityanalyzer
        flagged = list(res.unstable_circuits)
        t0 = time.time()
        comp = DataComparator(list(halves), device=device).run()
        comp_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 1e6
        log("drift %s: rate %.6g per step; draw %.3f s, dataset build %.3f s; StabilityAnalysis"
            ".run %.3f s (clickstreams %.3f s, spectra %.3f s of %s f64, detection %.3f s, the "
            "flagged circuits' trajectories the rest); DataComparator %.3f s; peak %.1f MB; "
            "flagged %d of %d by the analyzer (tests %s, per-circuit power threshold %.4f), "
            "%d by DataComparator (aggregate N_sigma %.3f)"
            % (tag, rate, draw_s, build_s, run_s, an.seconds['clickstreams'],
               an.seconds['spectra'], an._basespectra.shape, an.seconds['detection'], comp_s,
               peak, len(flagged), len(circuits), an._condtests[an._def_detection],
               an.power_threshold(('circuit',)), len(comp.inconsistent_circuits),
               comp.aggregate_nsigma))
        runs[tag] = (res, comp, P)
    res, comp, P = runs['drifting']
    an = res.stabilityanalyzer
    flagged = list(res.unstable_circuits)
    # the characterization: 'filter' on every circuit, 'mle' on the five of
    # largest power in the per-circuit test's spectra
    an.run_instability_characterization(estimator='filter')
    filter_s = an.seconds['characterization']
    power = an._averaged_spectra(('circuit',))[:, 1:].max(axis=1)
    top5 = [an._circuits[j] for j in np.argsort(-power, kind='stable')[:5]]
    an.run_instability_characterization(estimator='mle', circuits=top5, default=False)
    mle_s = an.seconds['characterization']
    bounds = [an.maximum_tvd_bound(c, estimator='mle') for c in top5]
    log("drift drifting: characterization 'filter' of all %d circuits %.3f s, 'mle' of the 5 "
        "of largest power %.3f s (%s: max powers %s, TVD bounds filter %s, mle %s); largest "
        "TVD bound over all circuits %.4f"
        % (len(circuits), filter_s, mle_s, [c.str for c in top5],
           ["%.2f" % p for p in np.sort(power)[::-1][:5]],
           ["%.4f" % an.maximum_tvd_bound(c) for c in top5], ["%.4f" % b for b in bounds],
           an.maxmax_tvd_bound()))
    # the noiseless spectra: the same standardized DCT of the exact
    # trajectories, averaged over the independent outcomes as the test is
    exact = P.permute(1, 2, 0)[:, :-1, :]                            # [C, n_out - 1, T]
    noiseless = signal.dct_power_spectra(exact, device).mean(dim=1)[:, 1:].max(dim=1).values
    threshold = an.power_threshold(('circuit',))
    must = {c.str for c, p in zip(circuits, noiseless.cpu().numpy()) if p >= 3 * threshold}
    got = {c.str for c in flagged}
    others = [c for c in flagged if not contains_gxpi2_0(c)]
    # the card's spectra against the CPU path on 100 circuits
    rows = np.linspace(0, len(circuits) - 1, 100).astype(int)
    indep = an._outcomes[:-1]
    X = np.array([[an._timeinfo[(an._dskeys[0], an._circuits[j])][1].get(
        o, np.zeros(DRIFT_T))[:DRIFT_T] for o in indep] for j in rows])
    cpu = signal.dct_power_spectra(X, 'cpu').numpy()
    cpu[X.std(axis=-1) == 0] = 0.0
    spec_err = float(np.max(np.abs(cpu - an._basespectra[0, rows])))
    static_res, static_comp, _ = runs['static']
    log("drift drifting: %d circuits whose noiseless spectrum has a mode >= 3x the threshold, "
        "%d of them flagged; %d flagged circuits without Gxpi2:0 (%s); the card's spectra vs "
        "the CPU path on 100 circuits: max abs diff %.3e (tol 1e-12); phase %.1f s"
        % (len(must), len(must & got), len(others), [c.str for c in others][:3], spec_err,
           time.time() - t_phase))
    page, page_bytes, page_s = written(create_drift_report(res).write_html, 'drift.html')
    rows = page.count('<tr><td style="font-family:monospace">')
    log("drift drifting: create_drift_report written in %.3f s, %d bytes: '%d drifting' %s, "
        "%d rows of drifting circuits" % (page_s, page_bytes, len(flagged),
                                          '%d drifting' % len(flagged) in page, rows))
    if '%d drifting' % len(flagged) not in page or rows != len(flagged):
        raise SystemExit("drift: the report lacks the flagged circuits")
    if not res.instability_detected:
        raise SystemExit("drift: no drift detected in the drifting data")
    if len(others) > 1:
        raise SystemExit("drift: %d flagged circuits lack Gxpi2:0" % len(others))
    if not must <= got:
        raise SystemExit("drift: %d circuits with a strong noiseless mode were not flagged"
                         % len(must - got))
    if not spec_err < 1e-12:
        raise SystemExit("drift: the card's spectra disagree with the CPU path")
    if len(static_res.unstable_circuits) > 1 or len(static_comp.inconsistent_circuits) > 1:
        raise SystemExit("drift: the static data flag %d circuits (analyzer) and %d "
                         "(DataComparator)" % (len(static_res.unstable_circuits),
                                               len(static_comp.inconsistent_circuits)))
    if not comp.aggregate_nsigma > 10:
        raise SystemExit("drift: DataComparator's aggregate N_sigma on the drifting halves "
                         "is %g" % comp.aggregate_nsigma)


FOGI_RATE = 1e-3         # phase 29: the planted rates' scale (H normal, S |normal|)
LEAK_ANGLE = 0.05        # phase 30: Gxpi2:0's rotation of |1> toward |2>, rad
LEAK_MARGIN = 0.3        # phase 30: the leakage rate's relative margin
LEAK_BOOTSTRAPS = 4      # phase 30: bootstrap refits behind that margin


def planted_hs_model(mp, rate, seed):
    """The pack's 'H+s' target with seeded rates: each member's H rates
    normal(0, rate), its S rates |normal(0, rate)| (so the truth is CPTP)."""
    m = mp.target_model('H+s')
    rs = np.random.RandomState(seed)
    for member in list(m.operations.values()) + list(m.preps.values()) \
            + list(m.povms.values()):
        member.set_errorgen_coefficients({
            l: rate * (rs.randn() if l.errorgen_type == 'H' else abs(rs.randn()))
            for l in member.errorgen_coefficient_labels()})
    m._mark_for_rebuild()
    return m


def phase_fogi_fit(mp, lists, builders, device):
    """Phase 29: smq2Q_XYICNOT 'H+s' (240 parameters) with its FOGI
    decomposition set up on the host (174 FOGI, 66 FOGV directions), a truth
    of planted FOGI components, cell 1's 13,958 circuits at 1,000 shots
    drawn on the card, fitted from the target through GateSetTomography.run
    (a) in FOGI coordinates, 174 parameters through the interposer, and (b)
    in the raw 'H+s' coordinates; the reparameterized Tv card against CPU
    and jacfwd, the kernel at the fit's buckets.  Returns {path: launches}."""
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                GSTInitialModel)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    from pygsti_tpu_torch.report.fogidiagram import FOGIDiagram
    from pygsti_tpu_torch.tools.optools import entanglement_infidelity
    t_phase = time.time()
    final = list(lists[-1])

    # -- the FOGI decomposition, on the host ----------------------------------
    fogi_target = mp.target_model('H+s')
    t0 = time.time()
    store = fogi_target.setup_fogi(include_spam=True, reparameterize=True)
    setup_s = time.time() - t0
    counts = (store.num_fogi_directions, store.num_fogv_directions, fogi_target.num_params,
              fogi_target.num_member_params)
    log("fogi: setup_fogi(include_spam=True, reparameterize=True) on the host in %.3f s: %d "
        "FOGI and %d FOGV directions, %d model parameters over %d member parameters"
        % ((setup_s,) + counts))
    if counts != (174, 66, 174, 240):
        raise SystemExit("fogi: unexpected FOGI decomposition %s" % (counts,))

    # -- the truth: planted FOGI components (and FOGV ones), data on the card --
    physical = planted_hs_model(mp, FOGI_RATE, 1234)
    physical.setup_fogi(include_spam=True)
    comps = physical.fogi_errorgen_components_array(include_fogv=True)
    truth = mp.target_model('H+s')
    truth.setup_fogi(include_spam=True)
    truth.set_fogi_errorgen_components_array(comps, include_fogv=True)
    planted = comps[:store.num_fogi_directions]
    back = float(np.max(np.abs(truth.to_vector() - physical.to_vector())))
    infids = [entanglement_infidelity(op.dense(), t.dense())
              for op, t in zip(truth.operations.values(),
                               mp.target_model('full').operations.values())]
    t0 = time.time()
    ds = simulate_data(truth, final, 1000, seed=1234, device=device)
    log("fogi: truth of seeded rates (H normal, S |normal|, scale %g) set through "
        "set_fogi_errorgen_components_array (FOGI + FOGV; back to the raw rates within %.1e); "
        "planted FOGI components |max| %.3e, rms %.3e; entanglement infidelities of the ops "
        "%s; %d circuits x 1000 shots drawn on the card in %.2f s (seed 1234)"
        % (FOGI_RATE, back, np.max(np.abs(planted)), np.sqrt(np.mean(planted ** 2)),
           ['%.2e' % x for x in infids], len(final), time.time() - t0))
    if not back < 1e-12:
        raise SystemExit("fogi: the components do not give the truth's rates back")

    # -- the reparameterized Tv: card, CPU, jacfwd; its cost ------------------
    v_card = torch.as_tensor(planted, dtype=torch.float64, device=device)
    Tv_card = fogi_target.flat_tensors_jacobian_fn()(v_card)
    Tv_cpu = fogi_target.flat_tensors_jacobian_fn()(v_card.cpu())
    J_fwd = torch.func.jacfwd(fogi_target.flat_tensors_fn())(v_card)
    scale = float(Tv_cpu.abs().max())
    rel_cpu = float((Tv_card.cpu() - Tv_cpu).abs().max()) / scale
    rel_fwd = float((Tv_card - J_fwd).abs().max()) / scale
    raw = mp.target_model('H+s')
    w_card = torch.as_tensor(fogi_target.param_interposer.model_paramvec_to_ops_paramvec(planted),
                             dtype=torch.float64, device=device)
    timings = {}
    for name, m, v in (('with the interposer', fogi_target, v_card),
                       ('without (the raw model at M v)', raw, w_card)):
        flat, jac = m.flat_tensors_fn(), m.flat_tensors_jacobian_fn()
        timings[name] = cuda_time_ms(lambda: (flat(v), jac(v)), 10)
    log("fogi: Tv [%d x %d] of the reparameterized model on the card against the CPU path: "
        "max rel %.3e, against torch.func.jacfwd of the flat tensors on the card: max rel %.3e "
        "(tol 1e-12); one tensors_fn + Tv: %s"
        % (Tv_card.shape[0], Tv_card.shape[1], rel_cpu, rel_fwd,
           ", ".join("%.3f ms %s" % (ms, k) for k, ms in timings.items())))
    if not (rel_cpu < 1e-12 and rel_fwd < 1e-12):
        raise SystemExit("fogi: the reparameterized Tv disagrees with the CPU path or jacfwd")

    # -- the two fits --------------------------------------------------------
    def run_fit(model, prefix):
        gst = GateSetTomography(GSTInitialModel(model=model), gaugeopt_suite=None,
                                objfn_builders=builders, optimizer={'maxiter': LM_MAXITER},
                                verbosity=0, device=device)
        return fit_launches(gst, ProtocolData(GateSetTomographyDesign(model, lists), ds),
                            prefix, lists)
    est_a, la, fit_a_s, it_a, peak_a = run_fit(fogi_target.copy(), 'fogi fit (a)')
    est_b, lb, fit_b_s, it_b, peak_b = run_fit(mp.target_model('H+s'), 'fogi fit (b)')
    fa, fb = est_a.models['final iteration estimate'], est_b.models['final iteration estimate']
    layout = SimpleForwardSimulator(fa, device).create_layout(final)
    nb = num_buckets(layout, fa, device)
    val_a, val_b = est_a.parameters['final_objfn_value'], est_b.parameters['final_objfn_value']
    ns_a, ns_b = est_a.misfit_sigma(), est_b.misfit_sigma()
    for tag, est, launches, fit_s, iters, peak, m in (
            ('(a) FOGI', est_a, la, fit_a_s, it_a, peak_a, fa),
            ('(b) raw', est_b, lb, fit_b_s, it_b, peak_b, fb)):
        log("fogi fit %s: %d parameters, %d LM iterations in %.3f s (%.1f ms each); final "
            "2*DeltaLogL %.6f, k %d, N_sigma %.4f; kernel launches {'bwd_jacobian': %d} "
            "(%d buckets x %d iterations = %d); peak device memory %.1f MB"
            % (tag, m.num_params, iters, fit_s, 1e3 * fit_s / max(iters, 1),
               est.parameters['final_objfn_value'], est.parameters['final_dof'],
               est.misfit_sigma(), launches, nb, iters, nb * iters, peak))
        if launches != nb * iters:
            raise SystemExit("fogi fit %s: the kernel's launches are not the buckets times "
                             "the LM iterations" % tag)
        if not (np.all(np.isfinite(m.to_vector())) and est.misfit_sigma() < 10):
            raise SystemExit("fogi fit %s is not finite or far from the statistical optimum: "
                             "N_sigma %g" % (tag, est.misfit_sigma()))
    if fa.num_params != 174 or fa.param_interposer is None:
        raise SystemExit("fogi fit (a) lost its FOGI parameterization")
    log("fogi: 2*DeltaLogL (a) - (b) = %.6g (%.3e relative; the FOGI family lies inside the "
        "raw one, so (a) may not lie below (b) by more than 1e-6 relative)"
        % (val_a - val_b, (val_a - val_b) / abs(val_b)))
    if not val_a >= val_b - 1e-6 * abs(val_b):
        raise SystemExit("fogi: the FOGI fit lies below the raw fit")

    # -- the components against fit (b)'s and the planted ones ----------------
    t0 = time.time()
    crf = est_a.create_confidence_region_factory()
    crf.compute_hessian(approximate=True)
    sigma = np.sqrt(np.abs(np.diag(crf.project_hessian('none'))))
    hess_s = time.time() - t0
    theta_a = fa.to_vector()
    fb_f = fb.copy()
    fb_f.setup_fogi(include_spam=True)
    comps_b = fb_f.fogi_errorgen_components_array()
    fogv_b = fb_f.fogi_errorgen_components_array(include_fogv=True)[len(comps_b):]
    dev_ab = np.abs(comps_b - theta_a)
    z = np.abs(theta_a - planted) / sigma
    worst_ab = int(np.argmax(dev_ab / (3 * sigma + 1e-4)))
    worst_z = int(np.argmax(z))
    labels = fa.fogi_errorgen_component_labels()
    n_fogv = store.num_fogv_directions
    gain_bound = n_fogv + 5 * np.sqrt(2 * n_fogv)
    log("fogi: Gauss-Newton Hessian of fit (a) through the kernel and its inverse in %.3f s; "
        "sigma of the 174 components: min %.3e, median %.3e, max %.3e; |fit (a) - planted| / "
        "sigma: max %.3f (%s), rms %.3f; fit (a)'s parameters against its model's FOGI "
        "components: max |diff| %.3e" % (hess_s, sigma.min(), np.median(sigma), sigma.max(),
                                         z.max(), labels[worst_z], np.sqrt(np.mean(z ** 2)),
                                         float(np.max(np.abs(fa.fogi_errorgen_components_array()
                                                             - theta_a)))))
    # The raw 'H+s' coordinates are no gauge-fixed family: the first-order
    # gauge (FOGV) directions move the probabilities at second order, and
    # from the target the raw fit follows them far past first order, buying
    # at most what its n_fogv extra parameters can take from the noise.
    log("fogi: fit (b)'s FOGV components |max| %.3e (first order holds near 0); its FOGI "
        "components against fit (a)'s parameters: max |diff| %.3e, %.1f of (3 sigma + 1e-4) at "
        "%s; 2*DeltaLogL (a) - (b) = %.6g against the %d FOGV directions' chi2 allowance "
        "%d + 5 sqrt(2 x %d) = %.3f"
        % (np.max(np.abs(fogv_b)), dev_ab.max(), dev_ab[worst_ab] / (3 * sigma[worst_ab] + 1e-4),
           labels[worst_ab], val_a - val_b, n_fogv, n_fogv, n_fogv, gain_bound))
    if not val_a - val_b <= gain_bound:
        raise SystemExit("fogi: the raw fit lies further below the FOGI fit than its FOGV "
                         "directions allow")
    if not z.max() < 5:
        raise SystemExit("fogi: a fitted component lies %.2f sigma from the planted one"
                         % z.max())
    if not np.max(np.abs(fa.fogi_errorgen_components_array() - theta_a)) < 1e-10:
        raise SystemExit("fogi: fit (a)'s parameters are not its model's FOGI components")
    diagram = FOGIDiagram(fa)
    t0 = time.time()
    rows = diagram.rates_table()
    page, page_bytes, page_s = written(diagram.write_html, 'fogi.html')
    meta = fa.fogi_store.fogi_metadata
    store_rows = sorted((m['name'], float(r), 'intrinsic' if m['gaugespace_dir'] is None
                         else 'relational')
                        for m, r in zip(meta, fa.fogi_errorgen_components_array()))
    shown = sum(('%.3e' % r) in page for _, r, _ in rows[:50])
    log("fogi: FOGIDiagram of fit (a): %d rates (%d intrinsic), the table equal to the store's "
        "components %s; written in %.3f s (the table %.3f s), %d bytes, %d of the 50 largest "
        "rates shown" % (len(rows), sum(k == 'intrinsic' for _, _, k in rows),
                         sorted(rows) == store_rows, page_s, time.time() - t0 - page_s,
                         page_bytes, shown))
    if sorted(rows) != store_rows or shown != min(50, len(rows)):
        raise SystemExit("fogi: the diagram's rates are not the store's")

    errs, ms, plain_ms, einsum_ms, bound_ms, shapes = hold_kernel_at_buckets(
        layout, fa, device, 'fogi fit')
    log("fogi: the kernel at the fit's %d bucket shapes %s with this model's G (d %d): rel "
        "err f64 %.3e, f32 %.3e; %.4f ms per Jacobian (bound %.4f ms, %.1f%% of it), plain "
        "%.3f ms, einsum %.3f ms; phase %.1f s"
        % (len(shapes), shapes, fa.dim, errs[torch.float64], errs[torch.float32], ms, bound_ms,
           100 * bound_ms / ms, plain_ms, einsum_ms, time.time() - t_phase))
    return {'fogi fit (a)': la, 'fogi fit (b)': lb}


def leaky_truth(target3):
    """The 3-level target depolarized 0.01, its Gxpi2:0 followed by a
    rotation of |1> toward |2> by LEAK_ANGLE."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.tools.optools import unitary_to_superop
    truth = target3.depolarize(op_noise=0.01)
    rot = np.eye(3, dtype=complex)
    rot[1, 1] = rot[2, 2] = np.cos(LEAK_ANGLE)
    rot[1, 2], rot[2, 1] = -np.sin(LEAK_ANGLE), np.sin(LEAK_ANGLE)
    gx = truth.operations[Label('Gxpi2', 0)]
    truth.operations[Label('Gxpi2', 0)] = type(gx)(
        np.real(unitary_to_superop(rot, 'gm')) @ gx.dense())
    return truth


def phase_leakage_fit(builders, device):
    """Phase 30: leakage GST of one qubit: create_3level_model of smq1Q_XYI
    'full TP' (243 parameters, d 9, outcome '1' counting level 2), a truth
    depolarized 0.01 whose Gxpi2:0 leaks, the lite design at maxL 1..64 at
    1,000 shots drawn on the card, GateSetTomography.run from the target,
    then add_lago_models; the kernel at this layout's buckets (d 9, NOUT 2).
    Returns {path: launches}."""
    from pygsti_tpu_torch import leakage
    from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.modelpacks import smq1Q_XYI as mp1
    from pygsti_tpu_torch.models.gaugegroup import TPGaugeGroup
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                GSTInitialModel)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    t_phase = time.time()
    gx = Label('Gxpi2', 0)
    target = leakage.create_3level_model(mp1.target_model('full TP'), gate_type='full TP')
    lists = create_lsgst_circuit_lists(target, mp1.prep_fiducials(), mp1.meas_fiducials(),
                                       mp1.germs(lite=True), [1, 2, 4, 8, 16, 32, 64])
    final = list(lists[-1])
    log("leakage: create_3level_model(smq1Q_XYI 'full TP'): %d parameters, %d operations, d "
        "%d, outcomes %s; design %d lists, final %d circuits, depth %d"
        % (target.num_params, len(target.operations), target.dim,
           target.povms['Mdefault'].outcome_labels, len(lists), len(final),
           max(c.depth for c in final)))
    if (target.num_params, len(target.operations), target.dim, len(final)) != (243, 3, 9, 793):
        raise SystemExit("leakage: unexpected 3-level model or design")
    truth = leaky_truth(target)
    rate_true = leakage.gate_leakage_rate(truth.operations[gx].dense())
    seep_true = leakage.gate_seepage_rate(truth.operations[gx].dense())
    t0 = time.time()
    ds = simulate_data(truth, final, 1000, seed=1234, device=device)
    log("leakage: truth depolarized 0.01, Gxpi2:0 then |1>->|2> by %g rad: leakage rate %.6g, "
        "seepage %.6g; %d circuits x 1000 shots drawn on the card in %.2f s (seed 1234)"
        % (LEAK_ANGLE, rate_true, seep_true, len(final), time.time() - t0))
    layout = SimpleForwardSimulator(target, device).create_layout(final)
    errs, ms, plain_ms, einsum_ms, bound_ms, shapes = hold_kernel_at_buckets(
        layout, target, device, 'leakage')
    log("leakage: the kernel at this layout's %d bucket shapes %s (d 9, NOUT 2, K1 %d): rel err "
        "f64 %.3e, f32 %.3e; %.4f ms per Jacobian against a bound of %.4f ms (%.1f%% of it), "
        "plain %.3f ms, einsum %.3f ms"
        % (len(shapes), shapes, len(target.op_keys) + 1, errs[torch.float64],
           errs[torch.float32], ms, bound_ms, 100 * bound_ms / ms, plain_ms, einsum_ms))

    gst = GateSetTomography(GSTInitialModel(model=target.copy()), gaugeopt_suite=None,
                            objfn_builders=builders, optimizer={'maxiter': LM_MAXITER},
                            verbosity=0, device=device)
    est, launches, fit_s, iters, peak = fit_launches(
        gst, ProtocolData(GateSetTomographyDesign(target, lists), ds), 'leakage fit', lists)
    fitted = est.models['final iteration estimate']
    nb = num_buckets(layout, fitted, device)
    nsigma = est.misfit_sigma()
    from pygsti_tpu_torch.objectivefns.objectivefns import two_delta_logl
    truth_value = two_delta_logl(truth, ds, final, device=device)
    log("leakage fit: %d LM iterations in %.3f s (%.1f ms each); final 2*DeltaLogL %.6f (the "
        "truth's %.6f), k %d, N_sigma %.4f; kernel launches {'bwd_jacobian': %d} (%d buckets "
        "x %d iterations = %d); peak device memory %.1f MB"
        % (iters, fit_s, 1e3 * fit_s / max(iters, 1), est.parameters['final_objfn_value'],
           truth_value, est.parameters['final_dof'], nsigma, launches, nb, iters, nb * iters,
           peak))
    if launches != nb * iters:
        raise SystemExit("leakage fit: the kernel's launches are not the buckets times the LM "
                         "iterations")
    if not (np.all(np.isfinite(fitted.to_vector())) and nsigma < 10):
        raise SystemExit("leakage fit is not finite or far from the statistical optimum: "
                         "N_sigma %g" % nsigma)

    # -- LAGO ----------------------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.time()
    leakage.add_lago_models(est.parent, device=device)
    lago_s = time.time() - t0
    lago = est.models['LAGO']
    suite = leakage.std_lago_gopsuite(fitted)['LAGO'][0]
    again, x, el = gaugeopt_to_target(fitted, est.models['target'], item_weights=suite[
        'item_weights'], gauge_group=suite['gauge_group'], return_all=True, device=device)
    R = leakage.subspace_restriction(el.transform_matrix, 'gm')
    orth = float(np.max(np.abs(R @ R.T - np.eye(4))))
    sim_f = SimpleForwardSimulator(fitted, device)
    p_fit = sim_f.bulk_fill_probs(None, layout)
    dp = max(float(np.max(np.abs(SimpleForwardSimulator(m, device).bulk_fill_probs(None, layout)
                                 - p_fit))) for m in (lago, again))
    rate_lago = leakage.gate_leakage_rate(lago.operations[gx].dense())
    seep_lago = leakage.gate_seepage_rate(lago.operations[gx].dense())
    tgt_gx = est.models['target'].operations[gx].dense()
    log("leakage: add_lago_models (std_lago_gopsuite: U(2)+U(1), %d parameters) in %.3f s; "
        "probabilities of all %d circuits against the fit's: max |dp| %.3e (tol 1e-9); the "
        "element's computational-subspace restriction R: max |R R^T - I| %.3e (tol 1e-8); the "
        "LAGO Gxpi2:0: leakage rate %.6g (the truth's %.6g), seepage %.6g (the truth's %.6g), "
        "subspace entanglement fidelity to the target %.6f, subspace jtracedist %.3e"
        % (suite['gauge_group'].num_params, lago_s, len(final), dp, orth, rate_lago,
           rate_true, seep_lago, seep_true,
           leakage.subspace_entanglement_fidelity(lago.operations[gx].dense(), tgt_gx, 'gm'),
           leakage.subspace_jtracedist(lago.operations[gx].dense(), tgt_gx, 'gm')))
    if not (dp < 1e-9 and orth < 1e-8):
        raise SystemExit("leakage: LAGO changed the probabilities or left the direct-sum group")

    # The leakage rate is a property of a frame, and U(2)+U(1) fixes only
    # the unitary part of it: the fit keeps whatever non-unitary TP gauge
    # the optimizer left it in.  So the rate is compared in one frame for
    # both: the fit and the truth each gauge-optimized to the target over
    # the TP group, then through the LAGO suite.
    def framed(m):
        m = gaugeopt_to_target(m, est.models['target'], gauge_group=TPGaugeGroup(m.dim),
                               device=device)
        return gaugeopt_to_target(m, est.models['target'], item_weights=suite['item_weights'],
                                  gauge_group=suite['gauge_group'], device=device)
    t0 = time.time()
    fit_framed, truth_framed = framed(fitted), framed(truth)
    frame_s = time.time() - t0
    rate_fit = leakage.gate_leakage_rate(fit_framed.operations[gx].dense())
    rate_ref = leakage.gate_leakage_rate(truth_framed.operations[gx].dense())
    # the rate's spread in that frame: parametric bootstrap refits from
    # the target (create_bootstrap_models), each framed alike
    from pygsti_tpu_torch.drivers.bootstrap import create_bootstrap_models
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    boot_stats = []
    torch.cuda.synchronize()
    bwd_jacobian_accumulate.launches = 0
    t0 = time.time()
    boots = create_bootstrap_models(
        LEAK_BOOTSTRAPS, ds, 'parametric', mp1.prep_fiducials(), mp1.meas_fiducials(),
        mp1.germs(lite=True), [1, 2, 4, 8, 16, 32, 64], input_model=fitted,
        target_model=target, start_seed=2030, verbosity=0, device=device, stats=boot_stats)
    boot_rates = [leakage.gate_leakage_rate(framed(m).operations[gx].dense()) for m in boots]
    torch.cuda.synchronize()
    boot_launches = bwd_jacobian_accumulate.launches
    sigma_rate = float(np.std(boot_rates, ddof=1))
    log("leakage: in one frame (TP gauge-optimization to the target, then the LAGO suite; "
        "%.3f s for both): the fit's leakage rate %.6g, the truth's %.6g (%.1f%% off; margin "
        "%d%%); %d parametric bootstrap refits from the target (%.1f s, %s LM iterations, "
        "%d kernel launches), framed alike: rates %s, spread %.3e, so the margin is %.1f of it"
        % (frame_s, rate_fit, rate_ref, 100 * abs(rate_fit / rate_ref - 1), 100 * LEAK_MARGIN,
           LEAK_BOOTSTRAPS, time.time() - t0,
           [sum(r.optimizer_specific_qtys['iterations'] for st in b['optimizer_results']
                for r in st) for b in boot_stats],
           boot_launches, ['%.6g' % r for r in boot_rates], sigma_rate,
           LEAK_MARGIN * rate_ref / sigma_rate))
    if not abs(rate_fit - rate_ref) <= LEAK_MARGIN * rate_ref:
        raise SystemExit("leakage: the fitted leakage rate is not within %d%% of the truth's"
                         % (100 * LEAK_MARGIN))
    log("leakage: phase %.1f s" % (time.time() - t_phase))
    return {'leakage fit': launches, 'leakage bootstrap': boot_launches}


def phase_report_quantities(target, datagen, fitted, gauged, ds, lists, device):
    """Phase 31: the report quantities of phase 3's estimate, through the
    host API of tools/optools, the projections, the wildcard objective,
    check_jac of the kernel's Jacobian and the circuit methods; nothing is
    refitted.  Returns the kernel's launches in the Jacobian check."""
    from pygsti_tpu_torch.circuits.circuit import CompressedCircuit
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.objectivefns.objectivefns import (LogLWildcardFunction,
                                                            ObjectiveFunctionBuilder)
    from pygsti_tpu_torch.objectivefns.wildcardbudget import PrimitiveOpsWildcardBudget
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    from pygsti_tpu_torch.optimize.optimize import check_jac
    from pygsti_tpu_torch.tools import jamiolkowski as jam
    from pygsti_tpu_torch.tools import optools as ot
    t_phase = time.time()
    final, first = list(lists[-1]), list(lists[0])
    ops = list(target.operations.keys())

    # -- (1) the metrics of each operation, host numpy -------------------------
    t0 = time.time()
    models = {'fitted': fitted, 'gauged': gauged, 'datagen': datagen}
    metrics = {}
    for lbl in ops:
        T = target.operations[lbl].dense()
        for name, m in models.items():
            G = m.operations[lbl].dense()
            metrics[name, lbl] = {
                'EI': ot.entanglement_infidelity(G, T),
                'EEI': ot.eigenvalue_entanglement_infidelity(G, T),
                'EVI': ot.eigenvalue_infidelity(jam.jamiolkowski_iso(G), jam.jamiolkowski_iso(T)),
                'GI': ot.generator_infidelity(G, T)}
        f, g, d = (metrics[name, lbl] for name in ('fitted', 'gauged', 'datagen'))
        log("report: %-10s entanglement infidelity %.6e (truth %.6e); eigenvalue ent. "
            "infidelity %.6e fitted, %.6e gauged, %.6e truth; eigenvalue infidelity of the "
            "Choi matrices %.6e fitted, %.6e gauged, %.6e truth; generator infidelity %.6e "
            "(truth %.6e)" % (lbl, g['EI'], d['EI'], f['EEI'], g['EEI'], d['EEI'], f['EVI'],
                              g['EVI'], d['EVI'], g['GI'], d['GI']))
        # a gauge transformation keeps a superoperator's eigenvalues: the
        # eigenvalue entanglement infidelity cannot move under it (the Choi
        # spectrum of eigenvalue_infidelity can, so it is logged only)
        if not abs(f['EEI'] - g['EEI']) <= 1e-9:
            raise SystemExit("report: the eigenvalue entanglement infidelity of %s moved under "
                             "gauge optimization: %.12g -> %.12g" % (lbl, f['EEI'], g['EEI']))
        if not abs(g['EEI'] - d['EEI']) <= 0.1 * d['EEI']:
            raise SystemExit("report: the eigenvalue entanglement infidelity of %s, %.6g, is "
                             "not within 10%% of the truth's %.6g" % (lbl, g['EEI'], d['EEI']))
        if not all(np.isfinite(v) for m in (f, g, d) for v in m.values()):
            raise SystemExit("report: a metric of %s is not finite" % lbl)
    gs = {it: ot.gateset_infidelity(gauged, target, it) for it in ('EI', 'AGI')}
    povm = {fn: getattr(ot, fn)(gauged, target, 'Mdefault')
            for fn in ('povm_fidelity', 'povm_jtracedist', 'povm_diamonddist')}
    negs = jam.sums_of_negative_choi_eigenvalues(gauged)
    spam_eg = ot.spam_error_generator(gauged.preps['rho0'].dense(), target.preps['rho0'].dense())
    t_metrics = time.time() - t0
    log("report: gate-set infidelity EI %.6e, AGI %.6e; POVM 'Mdefault' fidelity %.9f, "
        "jtracedist %.6e, diamonddist %.6e; sums of negative Choi eigenvalues %s; rho0's "
        "error generator norm %.6e; %.2f s on the host"
        % (gs['EI'], gs['AGI'], povm['povm_fidelity'], povm['povm_jtracedist'],
           povm['povm_diamonddist'], ['%.3e' % x for x in negs], np.linalg.norm(spam_eg),
           t_metrics))
    if not all(np.isfinite(v) for v in list(gs.values()) + list(povm.values()) + negs):
        raise SystemExit("report: a model-level metric is not finite")

    # -- (2) the projections, each evaluated on the full dataset on the card ----
    # project_model's default 'logG-logT' generator takes the principal logs
    # of G and of its target apart, so a gate with eigenvalue -1 (the CNOT)
    # gets a generator off by the branch (ROADMAP.md section 3); 'logGTi',
    # the log of T^-1 G near the identity, is run beside it
    kinds = ('H', 'S', 'H+S', 'LND', 'LNDF')
    logl = ObjectiveFunctionBuilder('logl', regularization={'min_prob_clip': MINCLIP,
                                                            'radius': MINCLIP})
    layout = SimpleForwardSimulator(gauged, device).create_layout(final, ds)
    n_data = ds.degrees_of_freedom(final)
    n = len(ops)
    t_project = t_proj_eval = 0.0
    for gen_type in ('logG-logT', 'logGTi'):
        t0 = time.time()
        projected, counts = ot.project_model(gauged, target, kinds, gen_type=gen_type)
        t_project += time.time() - t0
        if counts != [n * 15, n * 15, n * 30, n * 240, n * 240]:
            raise SystemExit("report: projection parameter counts %s" % (counts,))
        t0 = time.time()
        for kind, pm, npar in zip(kinds, projected, counts):
            two_dlogl = 2 * logl.build(pm, ds, final, device=device, layout=layout).fn()
            k = n_data - npar
            nsig = (two_dlogl - k) / np.sqrt(2 * k)
            dist = {str(l): float(np.max(np.abs(pm.operations[l].dense()
                                                 - gauged.operations[l].dense()))) for l in ops}
            far = max(dist, key=dist.get)
            log("report: projection %-9s %-4s %4d parameters: 2DeltaLogL %.6f, k %d, N_sigma "
                "%.4f; largest |projected - gauged| %.3e (%s)"
                % (gen_type, kind, npar, two_dlogl, k, nsig, dist[far], far))
            if not (np.isfinite(two_dlogl) and np.isfinite(nsig)):
                raise SystemExit("report: the %s projection's logL is not finite" % kind)
        t_proj_eval += time.time() - t0

    # -- (3) the wildcard objective over the final list's logL at the fit ------
    t0 = time.time()
    theta = fitted.to_vector()
    obj = logl.build(fitted, ds, final, device=device)
    wf = LogLWildcardFunction(obj, theta, PrimitiveOpsWildcardBudget(ops))
    base = float(np.sum(obj.terms(theta)))
    values = [wf.fn(np.full(n, w)) for w in (0.0, 1e-4, 1e-3, 1e-2)]
    log("report: wildcard logL on the final list: sum of terms %.9f; at w = 0, 1e-4, 1e-3, "
        "1e-2: %s" % (base, ['%.9f' % v for v in values]))
    if not abs(values[0] - base) <= 1e-12 * abs(base):
        raise SystemExit("report: the wildcard objective at w = 0 is not the objective's")
    if not all(b <= a for a, b in zip(values, values[1:])):
        raise SystemExit("report: the wildcard objective rose with the budget")
    first_terms = []
    for dev in (device, 'cpu'):
        o = logl.build(fitted, ds, first, device=dev)
        first_terms.append(LogLWildcardFunction(o, theta, PrimitiveOpsWildcardBudget(ops))
                           .terms(np.full(n, 1e-3)))
    rel = float(np.max(np.abs(first_terms[0] - first_terms[1])) / np.max(np.abs(first_terms[1])))
    t_wildcard = time.time() - t0
    log("report: wildcard terms on the card vs the CPU on the first list (%d circuits), w = "
        "1e-3: max rel diff %.3e (tol 1e-10); %.2f s" % (len(first), rel, t_wildcard))
    if not rel <= 1e-10:
        raise SystemExit("report: the wildcard terms on the card disagree with the CPU path")

    # -- (4) the kernel's Jacobian against forward differences -----------------
    chi2 = ObjectiveFunctionBuilder('chi2', regularization={
        'min_prob_clip_for_weighting': MINCLIP}).build(fitted, ds, first, device=device)
    torch.cuda.synchronize()
    bwd_jacobian_accumulate.launches = 0
    J = chi2.dlsvec(theta)
    torch.cuda.synchronize()
    launches = bwd_jacobian_accumulate.launches
    buckets = num_buckets(chi2.layout, fitted, device)
    p = chi2.probs(theta)
    keep = np.abs(p - MINCLIP) > 1e-6          # lsvec has a kink at the weighting clip
    scale = float(np.max(np.abs(J)))
    # the forward differences' truncation, eps times the curvature, reaches
    # 1e-5 of max |J| at eps 1e-7 on the rows of small p (6.6e-6 in a CPU
    # rehearsal on this list); eps 1e-8 is held, 1e-7 logged beside it
    t_check, worst = 0.0, {}
    for eps in (1e-7, 1e-8):
        t0 = time.time()
        err_sum, errs, fd = check_jac(chi2.lsvec, theta, J, eps=eps)
        t_check += time.time() - t0
        worst[eps] = float(np.max(np.abs(J[keep] - fd[keep])))
        log("report: check_jac of the kernel's chi2 Jacobian on the first list (%d circuits, "
            "%d rows, %d parameters), eps %g: max |J - fd| %.3e = %.3e of max |J|, %d rows "
            "within 1e-6 of the clip left out; err_sum %.6g, %d entries above the default "
            "relative tolerance 1e-5; %d lsvec calls in %.2f s"
            % (len(first), J.shape[0], J.shape[1], eps, worst[eps], worst[eps] / scale,
               int(np.sum(~keep)), err_sum, len(errs), len(theta) + 1, time.time() - t0))
        if J.shape != fd.shape:
            raise SystemExit("report: check_jac's differences have shape %s" % (fd.shape,))
    log("report: the kernel's Jacobian: %d launches for the list's %d buckets"
        % (launches, buckets))
    if not worst[1e-8] <= 1e-5 * scale:
        raise SystemExit("report: the kernel's Jacobian disagrees with forward differences: "
                         "%.3e of max |J| (tol 1e-5)" % (worst[1e-8] / scale))
    if launches != buckets:
        raise SystemExit("report: the Jacobian launched the kernel %d times for %d buckets"
                         % (launches, buckets))
    errs_k, ms, plain_ms, einsum_ms, bound_ms, shapes = hold_kernel_at_buckets(
        chi2.layout, fitted, device, 'report')
    log("report: the kernel at the first list's %d buckets %s: f64 %.4f ms per Jacobian "
        "against a %.4f ms byte bound (%.1f%%), plain %.3f ms, einsum yardstick %.3f ms; max "
        "rel err f64 %.3e, f32 %.3e"
        % (len(shapes), shapes, ms, bound_ms, 100 * bound_ms / ms, plain_ms, einsum_ms,
           errs_k[torch.float64], errs_k[torch.float32]))

    # -- (5) the circuit methods on every circuit of the design -----------------
    t0 = time.time()
    if not all(CompressedCircuit(c).expand() == c for c in final):
        raise SystemExit("report: a compressed circuit did not expand back")
    t1 = time.time()
    if not all(c.parallelize().num_gates == c.num_gates for c in final):
        raise SystemExit("report: parallelize changed a circuit's gate count")
    t2 = time.time()
    for c in final:
        lines = c.convert_to_openqasm().splitlines()
        if len(lines) != c.num_gates + 5 or not all(
                ln.startswith(('u3(', 'cx ')) for ln in lines[4:-1]):
            raise SystemExit("report: OpenQASM of %s: %s" % (c.str, lines))
    t3 = time.time()
    log("report: %d circuits: CompressedCircuit round trips in %.2f s, parallelize keeps "
        "num_gates in %.2f s, convert_to_openqasm in %.2f s (host)"
        % (len(final), t1 - t0, t2 - t1, t3 - t2))
    log("report: phase 31 took %.1f s: metrics %.2f s, project_model %.2f s, their logL on "
        "the card %.2f s, wildcard %.2f s, check_jac %.2f s"
        % (time.time() - t_phase, t_metrics, t_project, t_proj_eval, t_wildcard, t_check))
    return launches


INTERP_NODES = 21        # phase 32: nodes per grid axis
INTERP_HALF_WIDTH = 0.1  # phase 32: the grid's half-width in each angle, rad
INTERP_DEPOL = 0.01      # phase 32: the samples' fixed depolarization
# phase 32: the truth's (rotation angle off pi/2, axis tilt) per gate, rad, off the grid's nodes
INTERP_TRUTH = {('Gxpi2', 0): (0.012, 0.006), ('Gypi2', 0): (-0.007, -0.013),
                ('Gxpi2', 1): (0.018, -0.004), ('Gypi2', 1): (-0.015, 0.017)}


def tilted_rotation_ptm(name, qubit, theta, phi, depol):
    """The 2-qubit PTM of `name` ('Gxpi2' or 'Gypi2') on `qubit`: a
    rotation by theta about the gate's axis tilted by phi out of the XY
    plane toward Z, then depolarization `depol` of that qubit; the identity
    on the other."""
    from pygsti_tpu_torch.tools.optools import unitary_to_pauligate
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    sy = np.array([[0, -1j], [1j, 0]])
    sz = np.diag([1.0, -1.0]).astype(complex)
    axis = sx if name == 'Gxpi2' else sy
    h = np.cos(phi) * axis + np.sin(phi) * sz
    u = np.cos(theta / 2) * np.eye(2) - 1j * np.sin(theta / 2) * h
    one = np.diag([1.0] + [1 - depol] * 3) @ np.real(unitary_to_pauligate(u))
    return np.kron(one, np.eye(4)) if qubit == 0 else np.kron(np.eye(4), one)


def interpolated_model(mp, points, depol):
    """smq2Q_XYICNOT 'static' whose four single-qubit gates are
    InterpolatedDenseOps over the (theta, phi) grid of tilted, depolarized
    rotations, at `points` ({(name, qubit): (theta, phi)}); the samples
    built on the host."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.extras.interpygate import InterpolatedDenseOp
    h = INTERP_HALF_WIDTH
    thetas = np.linspace(np.pi / 2 - h, np.pi / 2 + h, INTERP_NODES)
    phis = np.linspace(-h, h, INTERP_NODES)
    model = mp.target_model('static')
    for (name, q), point in points.items():
        samples = np.stack([np.stack([tilted_rotation_ptm(name, q, t, p, depol) for p in phis])
                            for t in thetas])
        model.operations[Label(name, q)] = InterpolatedDenseOp([thetas, phis], samples, point)
    return model


def phase_interpolated_fit(mp, lists, builders, device):
    """Phase 32: smq2Q_XYICNOT 'static' with its four single-qubit gates
    InterpolatedDenseOps over 21 x 21 (rotation angle, axis tilt) grids (8
    physical parameters); data of the same model at off-node points, cell
    1's 13,958 circuits at 1,000 shots drawn on the card; the fit from the
    grid's midpoint through GateSetTomography.run (chi2 stages, then logL;
    no gauge: the SPAM and Gcnot are static).  Every parameter within 5
    Hessian sigma of the truth; Tv card against CPU and against central
    differences inside a cell; one jtj_jtf card against CPU; the kernel at
    the fit's buckets.  Returns the kernel's launches in the fit."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                GSTInitialModel)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData
    t_phase = time.time()
    final = list(lists[-1])
    truth_points = {k: (np.pi / 2 + dt, dp) for k, (dt, dp) in INTERP_TRUTH.items()}
    t0 = time.time()
    truth = interpolated_model(mp, truth_points, INTERP_DEPOL)
    start = interpolated_model(mp, {k: (np.pi / 2, 0.0) for k in INTERP_TRUTH}, INTERP_DEPOL)
    build_s = time.time() - t0
    exact_gap = max(float(np.max(np.abs(truth.operations[Label(*k)].dense()
                                        - tilted_rotation_ptm(k[0], k[1], t, p, INTERP_DEPOL))))
                    for k, (t, p) in truth_points.items())
    ideal_gap = max(float(np.max(np.abs(
        tilted_rotation_ptm(k[0], k[1], np.pi / 2, 0.0, 0.0)
        - mp.target_model('static').operations[Label(*k)].dense()))) for k in INTERP_TRUTH)
    log("interp: 4 InterpolatedDenseOps over %d x %d grids (theta pi/2 +- %g, phi +- %g rad) of "
        "%d x %d PTMs, built on the host in %.3f s; %d parameters; the samples at (pi/2, 0) "
        "without depolarization against the pack's target: max |diff| %.1e; the "
        "interpolation at the truth against the exact tilted rotations: max |diff| %.3e"
        % (INTERP_NODES, INTERP_NODES, INTERP_HALF_WIDTH, INTERP_HALF_WIDTH, truth.dim, truth.dim,
           build_s, truth.num_params, ideal_gap, exact_gap))
    if truth.num_params != 8 or not ideal_gap < 1e-12:
        raise SystemExit("interp: the interpolated model is not the pack's gates on its grid")
    t0 = time.time()
    ds = simulate_data(truth, final, 1000, seed=1234, device=device)
    torch.cuda.synchronize()
    sim_s = time.time() - t0
    log("interp: %d circuits x 1000 shots drawn on the card in %.2f s (seed 1234)"
        % (len(final), sim_s))

    # -- Tv: card against CPU, against central differences inside a cell -------
    v_truth = torch.as_tensor(truth.to_vector(), dtype=torch.float64, device=device)
    jac, flat = truth.flat_tensors_jacobian_fn(), truth.flat_tensors_fn()
    Tv_card = jac(v_truth)
    Tv_cpu = jac(v_truth.cpu())
    eps = 1e-6
    fd = torch.stack([(flat(v_truth + eps * e) - flat(v_truth - eps * e)) / (2 * eps)
                      for e in torch.eye(truth.num_params, dtype=torch.float64,
                                         device=device)], dim=1)
    scale = float(Tv_cpu.abs().max())
    rel_cpu = float((Tv_card.cpu() - Tv_cpu).abs().max()) / scale
    rel_fd = float((Tv_card - fd).abs().max()) / scale
    log("interp: Tv [%d x %d] at the truth: card against the CPU path max rel %.3e (tol "
        "1e-12), against central differences (eps %g, inside the cell) max rel %.3e (tol 1e-7)"
        % (Tv_card.shape[0], Tv_card.shape[1], rel_cpu, eps, rel_fd))
    if not (rel_cpu < 1e-12 and rel_fd < 1e-7):
        raise SystemExit("interp: Tv disagrees with the CPU path or central differences")

    # -- the fit -----------------------------------------------------------
    gst = GateSetTomography(GSTInitialModel(model=start), gaugeopt_suite=None,
                            objfn_builders=builders, optimizer={'maxiter': LM_MAXITER},
                            verbosity=0, device=device)
    est, launches, fit_s, iters, peak = fit_launches(
        gst, ProtocolData(GateSetTomographyDesign(start, lists), ds), 'interp fit', lists)
    fitted = est.models['final iteration estimate']
    layout = SimpleForwardSimulator(fitted, device).create_layout(final)
    nb = num_buckets(layout, fitted, device)
    nsigma = est.misfit_sigma()
    log("interp fit: %d parameters, %d LM iterations in %.3f s (%.1f ms each); final "
        "2*DeltaLogL %.6f, k %d, N_sigma %.4f; kernel launches {'bwd_jacobian': %d} (%d "
        "buckets x %d iterations = %d); peak device memory %.1f MB"
        % (fitted.num_params, iters, fit_s, 1e3 * fit_s / max(iters, 1),
           est.parameters['final_objfn_value'], est.parameters['final_dof'], nsigma, launches,
           nb, iters, nb * iters, peak))
    if launches != nb * iters:
        raise SystemExit("interp fit: the kernel's launches are not the buckets times the LM "
                         "iterations")
    theta = fitted.to_vector()
    if not (np.all(np.isfinite(theta)) and abs(nsigma) < 10):
        raise SystemExit("interp fit is not finite or far from the statistical optimum: "
                         "N_sigma %g" % nsigma)
    t0 = time.time()
    crf = est.create_confidence_region_factory()
    crf.compute_hessian(approximate=True)
    sigma = np.sqrt(np.abs(np.diag(crf.project_hessian('none'))))
    hess_s = time.time() - t0
    z = (theta - truth.to_vector()) / sigma
    log("interp: Gauss-Newton Hessian through the kernel and its inverse in %.3f s; fitted "
        "(theta - pi/2, phi) per gate %s; truth %s; sigma %s; z %s"
        % (hess_s, ['%.6f' % x for x in theta - np.tile([np.pi / 2, 0.0], 4)],
           ['%.6f' % x for x in truth.to_vector() - np.tile([np.pi / 2, 0.0], 4)],
           ['%.2e' % s for s in sigma], ['%.2f' % x for x in z]))
    if not np.max(np.abs(z)) < 5:
        raise SystemExit("interp: a fitted parameter lies %.2f sigma from the truth"
                         % np.max(np.abs(z)))

    # -- one jtj_jtf card against CPU; the kernel at the fit's buckets -----------
    first = list(lists[0])
    objs = [ObjectiveFunctionBuilder('chi2').build(fitted, ds, first, device=dev)
            for dev in (device, 'cpu')]
    rel = card_vs_cpu(objs, theta)
    log("interp: chi2 lsvec/JTJ/JTf on the card vs the CPU path (%d circuits): max rel diff "
        "%.3e (tol 1e-12)" % (len(first), rel))
    if not rel < 1e-12:
        raise SystemExit("interp: the card's J^T J disagrees with the CPU path")
    errs, ms, plain_ms, einsum_ms, bound_ms, shapes = hold_kernel_at_buckets(
        layout, fitted, device, 'interp fit')
    log("interp: the kernel at the fit's %d bucket shapes %s with the interpolated model's G "
        "(d %d): rel err f64 %.3e, f32 %.3e; %.4f ms per Jacobian (bound %.4f ms, %.1f%% of "
        "it), plain %.3f ms, einsum %.3f ms; build %.2f s, simulation %.2f s, fit %.2f s; "
        "phase %.1f s"
        % (len(shapes), shapes, fitted.dim, errs[torch.float64], errs[torch.float32], ms,
           bound_ms, 100 * bound_ms / ms, plain_ms, einsum_ms, build_s, sim_s, fit_s,
           time.time() - t_phase))
    return launches


IDT_QUBITS = ('Q0', 'Q1', 'Q2', 'Q3')   # phases 33-34: ibmq_bogota's first 4 qubits, a line
IDT_RATES = {'H(XIII)': 2e-3, 'H(IIZI)': 3e-3, 'S(IZII)': 4e-3, 'S(IIIX)': 1.5e-3,
             'S(IZZI)': 2.5e-3}         # phase 33: planted intrinsic idle rates
IDT_MAX_LENGTHS = (0, 1, 2, 4, 8, 16, 32)
IDT_SHOTS = 100000
# phase 33: the standard Pauli preparation and measurement words of Gxpi2/Gypi2
IDT_PREP_DICT = {'X': ('Gypi2',), 'Y': ('Gxpi2',) * 3, 'Z': (), '-X': ('Gypi2',) * 3,
                 '-Y': ('Gxpi2',), '-Z': ('Gxpi2', 'Gxpi2')}
IDT_MEAS_DICT = {'X': ('Gypi2',) * 3, 'Y': ('Gxpi2',), 'Z': (), '-X': ('Gypi2',),
                 '-Y': ('Gxpi2',) * 3, '-Z': ('Gxpi2', 'Gxpi2')}
CT_LENGTHS = (10, 20, 40)
CT_CIRCUITS = 200       # per length
CT_SHOTS = 100
CT_H = 0.05             # the planted 'XX' Hamiltonian rate of Gxpi2:Q1 on Q1 and Q2


def parity_weights(outcomes, positions, scale=1.0):
    """{outcome: scale * (-1)^(sum of its bits at `positions`)}."""
    return {o: scale * (-1.0) ** sum(int(o[0][i]) for i in positions) for o in outcomes}


def slope_covariance(slopes, probs, shots):
    """The covariance of linear functionals s_m = sum over (circuit, {outcome:
    weight}) of weight . frequencies, the frequencies of each circuit
    multinomial with `shots` draws from probs[circuit] ({outcome: p}):
    each circuit adds W (diag p - p p^T) W^T / shots over its functionals."""
    uses = {}
    for m, terms in enumerate(slopes):
        for c, w in terms:
            uses.setdefault(c, []).append((m, w))
    cov = np.zeros((len(slopes), len(slopes)))
    for c, mw in uses.items():
        outs = list(probs[c].keys())
        p = np.array([probs[c][o] for o in outs])
        W = np.array([[w.get(o, 0.0) for o in outs] for _, w in mw])
        idx = np.array([m for m, _ in mw])
        cov[np.ix_(idx, idx)] += W @ (np.diag(p) - np.outer(p, p)) @ W.T / shots
    return cov


def apply_slopes(slopes, ds):
    """Each functional's value on the dataset's frequencies."""
    return np.array([sum(sum(wt * ds[c][o] / ds[c].total for o, wt in w.items())
                         for c, w in terms) for terms in slopes])


def idt_protocol_linear_map(design, outcomes):
    """IdleTomography.run's estimate as a linear map of its slopes: (slopes
    as functionals of the frequencies, R, the rates' keys) with rates = R s
    (its slopes are unweighted linear fits, its rates least-squares
    solutions of fixed design matrices)."""
    from pygsti_tpu_torch.extras.idletomography.idtcore import (_joint_pair_design,
                                                                _weight1_design_matrix)
    import itertools
    Ns = np.asarray(design.max_lengths, dtype=float)
    c = np.polyfit(Ns, np.eye(len(Ns)), 1)[0]
    qpos = {q: i for i, q in enumerate(design.qubit_labels_list)}

    def slope(table_key_of_N, qubits):
        return [(table_key_of_N(N), parity_weights(outcomes, [qpos[q] for q in qubits], ck))
                for N, ck in zip(design.max_lengths, c)]
    slopes, blocks, keys = [], [], []
    M1, cols1 = _weight1_design_matrix()
    for q in design.qubit_labels_list:
        for prep, meas in itertools.product('XYZ', 'XYZ'):
            slopes.append(slope(lambda N: design.circuit_table[(q, prep, meas, N)], (q,)))
        blocks.append(np.linalg.pinv(M1))
        keys += [(q, col) for col in cols1]
    M2, col_keys, row_specs = _joint_pair_design()
    keep = [i for i, k in enumerate(col_keys) if k[0] == 'S' and isinstance(k[1], tuple)]
    for pair in sorted({k[0] for k in design.pair_table}):
        for spec in row_specs:
            if spec[0] == 'single':
                _, which, prep, meas = spec
                q = pair[which]
                slopes.append(slope(lambda N: design.circuit_table[(q, prep, meas, N)], (q,)))
            else:
                _, kind, pq = spec
                qubits = pair if kind == 'joint' else ((pair[0],) if kind == 'marg1'
                                                       else (pair[1],))
                slopes.append(slope(lambda N: design.pair_table[(pair, pq, N)], qubits))
        blocks.append(np.linalg.pinv(M2)[keep])
        keys += [(pair, col_keys[i]) for i in keep]
    R = np.zeros((sum(b.shape[0] for b in blocks), len(slopes)))
    r = s = 0
    for b in blocks:
        R[r:r + b.shape[0], s:s + b.shape[1]] = b
        r, s = r + b.shape[0], s + b.shape[1]
    return slopes, R, keys


def idt_protocol_rates(res, keys):
    return np.array([res.pair_rates[k[0]][k[1]] if isinstance(k[0], tuple)
                     else res.intrinsic_rates[k[0]][k[1]] for k in keys])


def do_idt_linear_map(res, outcomes):
    """do_idle_tomography's estimate ('separate' Jacobians, fit order 1) as
    a linear map of its observed rates, each a weighted linear fit whose
    weights are taken as fixed: (slopes as functionals of the frequencies,
    R) with [stochastic, affine, hamiltonian] = R s over the rates it
    extracted."""
    ne = len(res.error_list)
    prep_dict, meas_dict = res.prep_basis_strs, res.meas_basis_strs
    slopes, rows_same, rows_ham, rows_aff = [], [], [], []
    for typ in ('samebasis', 'diffbasis'):
        for (prep, meas), infos in zip(res.pauli_fidpairs.get(typ, []),
                                       res.observed_rate_infos.get(typ, [])):
            pf, mf = prep.to_circuit(prep_dict), meas.to_circuit(meas_dict)
            circuits = [pf + res.idle_str * L + mf for L in res.max_lengths]
            for key, info in infos.items():
                c = np.polyfit(res.max_lengths, np.eye(len(circuits)), 1,
                               w=info['weights'])[0]
                if typ == 'samebasis':
                    ws = [{(key.rep,): ck} for ck in c]
                    rows_same.append(info['jacobian row'])
                else:
                    pos = [i for i, ch in enumerate(key.rep) if ch != 'I']
                    sign = np.prod([meas.signs[i] for i in pos])
                    ws = [parity_weights(outcomes, pos, sign * ck) for ck in c]
                    rows_ham.append(info['jacobian row'])
                    if 'affine jacobian row' in info:
                        rows_aff.append(info['affine jacobian row'])
                slopes.append(list(zip(circuits, ws)))
    n_same = len(rows_same)
    rates = res.intrinsic_rates
    J = np.array(rows_same)
    if 'affine' not in rates:
        J = J[:, :ne]
    P_same = np.linalg.pinv(J)
    blocks = [P_same[:ne]] + ([P_same[ne:]] if 'affine' in rates else [])
    R = np.zeros((ne * (len(blocks) + 1), len(slopes)))
    for i, b in enumerate(blocks):
        R[i * ne:(i + 1) * ne, :n_same] = b
    P_ham = np.linalg.pinv(np.array(rows_ham))
    R[-ne:, n_same:] = P_ham
    if 'affine' in rates and rows_aff:
        R[-ne:, :n_same] = -P_ham @ np.array(rows_aff) @ P_same[ne:]
    return slopes, R


def do_idt_rates(res):
    rates = res.intrinsic_rates
    return np.concatenate([rates['stochastic']] + ([rates['affine']] if 'affine' in rates
                                                   else []) + [rates['hamiltonian']])


def phase_idt_crosstalk(device):
    """Phase 33: idle tomography and crosstalk detection on ibmq_bogota's
    first 4 qubits (a line; d 256), through the runners.  (a) An explicit
    model with static gates and a global idle exp(Lindblad 'H+s', weight <=
    2) of planted rates; an IdleTomographyDesign (maxweight 2) beside
    do_idle_tomography's circuits, drawn by DataCountsSimulator at 100,000
    shots on the card; IdleTomography through SimpleRunner, and
    do_idle_tomography on the same counts; every rate of both within 5
    standard errors (the binomial variances propagated through the slope
    fits and the least-squares inversions) of the same pipelines on the
    exact probabilities.  (b) A cloud-crosstalk model whose Gxpi2 on Q1
    carries an 'XX' Hamiltonian error on Q1 and Q2; 600 random circuits of
    crosstalk_detection_experiment at 100 shots drawn on the card;
    do_basic_crosstalk_detection finds the edge between Q1's setting and
    Q2's outcome, and none on data of the model without the error.  (a) and (b)
    run again as the two children of one combined design through a
    TreeRunner, each result held equal to its direct run."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.data.dataset import DataSet
    from pygsti_tpu_torch.extras import devices
    from pygsti_tpu_torch.extras.crosstalk import (crosstalk_detection_experiment,
                                                   do_basic_crosstalk_detection)
    from pygsti_tpu_torch.extras.idletomography import (IdleTomography,
                                                        IdleTomographyDesign,
                                                        create_idletomography_report,
                                                        do_idle_tomography,
                                                        make_idle_tomography_list, idttools)
    from pygsti_tpu_torch.models.modelconstruction import (create_cloud_crosstalk_model,
                                                           create_explicit_model)
    from pygsti_tpu_torch.modelmembers.operations import ExpErrorgenOp, build_lindblad_errorgen
    from pygsti_tpu_torch.protocols.protocol import (CombinedExperimentDesign,
                                                     DataCountsSimulator, ExperimentDesign,
                                                     Protocol, ProtocolData, ProtocolResults,
                                                     SimpleRunner, TreeRunner)
    t_phase = time.time()
    pspec = devices.create_processor_spec('ibmq_bogota', ('Gxpi2', 'Gypi2'),
                                          qubitsubset=list(IDT_QUBITS))
    nq = len(IDT_QUBITS)
    log("idt: processor spec of ibmq_bogota's qubits %s: gates %s, edges %s"
        % (pspec.qubit_labels, pspec.gate_names, pspec.qubit_graph.edges()))

    # -- (a) idle tomography -------------------------------------------------
    t0 = time.time()
    model = create_explicit_model(pspec, ideal_gate_type='static')
    model.operations[Label(())] = ExpErrorgenOp(build_lindblad_errorgen(
        'pp', 'H+s', dim=4 ** nq, max_weight=2))
    idttools.set_idle_errors(nq, model, IDT_RATES)
    ham_p, sto_p, _ = idttools.predicted_intrinsic_rates(nq, 2, model)
    design = IdleTomographyDesign(IDT_QUBITS, max_lengths=IDT_MAX_LENGTHS, maxweight=2)
    to_q = {i: q for i, q in enumerate(IDT_QUBITS)}
    functional = make_idle_tomography_list(nq, IDT_MAX_LENGTHS, (IDT_PREP_DICT, IDT_MEAS_DICT),
                                           maxweight=2)
    func_q = [c.map_state_space_labels(to_q) for c in functional]
    idt_node = CombinedExperimentDesign({'design': design,
                                         'functional': ExperimentDesign(func_q, IDT_QUBITS)})
    build_s = time.time() - t0
    t0 = time.time()
    data = DataCountsSimulator(model, IDT_SHOTS, seed=2026, device=device).run(idt_node)
    exact = DataCountsSimulator(model, IDT_SHOTS, sample_error='none',
                                device=device).run(idt_node)
    torch.cuda.synchronize()
    sim_s = time.time() - t0
    log("idt: %d parameters on the global idle (%d weight <= 2 error generators), %d "
        "design + %d do_idle_tomography circuits (depth <= %d), built in %.2f s; two datasets "
        "(%d shots, and the exact expectation) drawn on the card in %.2f s"
        % (model.operations[Label(())].num_params, len(idttools.allerrors(nq, 2)),
           len(design.all_circuits_needing_data), len(func_q),
           max(c.depth for c in idt_node.all_circuits_needing_data), build_s,
           IDT_SHOTS, sim_s))

    def by_int(ds):
        """The counts of do_idle_tomography's circuits keyed by them (it
        labels qubits 0..n-1; the model's are ibmq_bogota's)."""
        out = DataSet()
        for ci, cq in zip(functional, func_q):
            out.add_count_dict(ci, dict(ds[cq].counts))
        return out
    t0 = time.time()
    runs = {}
    for tag, d in (('noisy', data), ('exact', exact)):
        rd = SimpleRunner(IdleTomography(), edesign_type=IdleTomographyDesign).run(d)
        if rd.for_protocol or rd['functional'].for_protocol or \
                'IdleTomography' not in rd['design'].for_protocol:
            raise SystemExit("idt: SimpleRunner ran on nodes other than the design")
        runs[tag] = (rd['design'].for_protocol['IdleTomography'],
                     do_idle_tomography(nq, by_int(d.dataset), list(IDT_MAX_LENGTHS),
                                        (IDT_PREP_DICT, IDT_MEAS_DICT), maxweight=2))
    fit_s = time.time() - t0
    outcomes = list(exact.dataset[func_q[0]].counts.keys())
    probs = {c: {o: exact.dataset[c][o] / IDT_SHOTS for o in outcomes}
             for c in idt_node.all_circuits_needing_data}
    probs_int = {ci: probs[cq] for ci, cq in zip(functional, func_q)}
    # the protocol's rates
    slopes, R, keys = idt_protocol_linear_map(design, outcomes)
    se = np.sqrt(np.diag(R @ slope_covariance(slopes, probs, IDT_SHOTS) @ R.T))
    rec = float(np.max(np.abs(R @ apply_slopes(slopes, exact.dataset)
                              - idt_protocol_rates(runs['exact'][0], keys))))
    z_p = (idt_protocol_rates(runs['noisy'][0], keys)
           - idt_protocol_rates(runs['exact'][0], keys)) / np.maximum(se, 1e-15)
    # do_idle_tomography's rates
    slopes_f, R_f = do_idt_linear_map(runs['exact'][1], outcomes)
    se_f = np.sqrt(np.diag(R_f @ slope_covariance(slopes_f, probs_int, IDT_SHOTS) @ R_f.T))
    obs = np.array([info['rate'] for typ in ('samebasis', 'diffbasis')
                    for infos in runs['exact'][1].observed_rate_infos[typ]
                    for info in infos.values()])
    rec_f = float(np.max(np.abs(R_f @ obs - do_idt_rates(runs['exact'][1]))))
    z_f = (do_idt_rates(runs['noisy'][1]) - do_idt_rates(runs['exact'][1])) / \
        np.maximum(se_f, 1e-15)
    ne = len(runs['exact'][1].error_list)
    ex = runs['exact'][1].intrinsic_rates
    log("idt: IdleTomography via SimpleRunner and do_idle_tomography on both datasets in %.2f "
        "s (the exact one's rates from their linear maps: max |diff| %.1e and %.1e); "
        "protocol: %d rates, standard errors %.2e..%.2e, max |noisy - exact| / se %.2f; "
        "do_idle_tomography (%s): %d rates, standard errors %.2e..%.2e, max |z| %.2f"
        % (fit_s, rec, rec_f, len(keys), se.min(), se.max(), np.max(np.abs(z_p)),
           '+'.join(sorted(ex)), len(z_f), se_f.min(), se_f.max(), np.max(np.abs(z_f))))
    labels = [str(e) for e in runs['exact'][1].error_list]
    gaps = {'hamiltonian': ex['hamiltonian'] - ham_p, 'stochastic': ex['stochastic'] - sto_p}
    log("idt: planted %s; do_idle_tomography on the exact probabilities against "
        "predicted_intrinsic_rates: H max |gap| %.3e (at %s), S max |gap| %.3e (at %s); its "
        "rates at the planted labels %s"
        % (IDT_RATES, np.max(np.abs(gaps['hamiltonian'])),
           labels[int(np.argmax(np.abs(gaps['hamiltonian'])))], np.max(np.abs(gaps['stochastic'])),
           labels[int(np.argmax(np.abs(gaps['stochastic'])))],
           {k: '%.3e' % ex['hamiltonian' if k[0] == 'H' else 'stochastic'][labels.index(k[2:-1])]
            for k in IDT_RATES}))
    if not (rec < 1e-10 and rec_f < 1e-10):
        raise SystemExit("idt: the linear maps behind the standard errors are not the "
                         "estimators'")
    if not (np.max(np.abs(z_p)) < 5 and np.max(np.abs(z_f)) < 5):
        raise SystemExit("idt: a rate lies more than 5 standard errors from the exact "
                         "probabilities' estimate")
    noisy = runs['noisy'][0]
    page, page_bytes, page_s = written(
        lambda path: create_idletomography_report(noisy, path), 'idt.html')
    rates = [v for q in IDT_QUBITS for k, v in noisy.intrinsic_rates[q].items()
             if isinstance(k, tuple)]
    rates += [v for pr in noisy.pair_rates.values() for v in pr.values() if abs(v) > 1e-6]
    shown = sum(('<td>%.3e</td>' % v) in page for v in rates)
    log("idt: create_idletomography_report of the protocol's results written in %.3f s, %d "
        "bytes; %d of its %d intrinsic and pair rates shown" % (page_s, page_bytes, shown,
                                                                len(rates)))
    if shown != len(rates):
        raise SystemExit("idt: the report lacks the protocol's rates")

    # -- (b) crosstalk detection --------------------------------------------
    t0 = time.time()
    circuits, settings = crosstalk_detection_experiment(pspec, CT_LENGTHS, CT_CIRCUITS, seed=7)
    by_circuit = {}
    for c, s in zip(circuits, settings):
        by_circuit.setdefault(c, s)
    ct_design = ExperimentDesign(list(by_circuit), IDT_QUBITS)
    ct_model = create_cloud_crosstalk_model(
        pspec, lindblad_error_coeffs={'Gxpi2': {('H', 'XX:@0,Q2'): CT_H}})
    for key, member in ct_model.operation_blks['cloudnoise'].items():
        if key != ('Gxpi2', ('Q1',)):       # the error on Gxpi2:Q1 only
            member.from_vector(np.zeros(member.num_params))
    ct_model._mark_for_rebuild()
    null_model = create_cloud_crosstalk_model(pspec)
    ct_data = {}
    for tag, m in (('crosstalk', ct_model), ('null', null_model)):
        ds = DataCountsSimulator(m, CT_SHOTS, seed=8, device=device).run(ct_design).dataset
        for c in ds.keys():
            ds.auxInfo[c]['settings'] = {(r,): s for r, s in enumerate(by_circuit[c])}
        ct_data[tag] = ds
    torch.cuda.synchronize()
    ct_sim_s = time.time() - t0
    t0 = time.time()
    found = {tag: do_basic_crosstalk_detection(ds, nq, settings=[1] * nq, confidence=0.95,
                                               verbosity=0) for tag, ds in ct_data.items()}
    ct_s = time.time() - t0
    log("crosstalk: %d circuits (%d distinct; lengths %s, %d per length, populations of 3 "
        "sequences) x %d shots drawn on the card for each model in %.2f s; "
        "do_basic_crosstalk_detection (%d x %d data matrix) on both in %.2f s: pairs "
        "(setting region, outcome region) %s with the error (max TVD %s), %s without"
        % (len(circuits), len(by_circuit), CT_LENGTHS, CT_CIRCUITS, CT_SHOTS, ct_sim_s,
           found['crosstalk'].number_of_datapoints, found['crosstalk'].number_of_columns, ct_s,
           found['crosstalk'].crosstalk_pairs,
           {k: '%.3f' % v for k, v in (found['crosstalk'].max_tvds or {}).items()},
           found['null'].crosstalk_pairs))
    if not {(1, 2), (2, 1)} & set(found['crosstalk'].crosstalk_pairs):
        raise SystemExit("crosstalk: the planted edge between Q1's setting and Q2's outcome "
                         "was not found")
    if found['null'].crosstalk_pairs:
        raise SystemExit("crosstalk: edges found on data of the model without crosstalk")

    # -- both through one TreeRunner ----------------------------------------
    class CrosstalkDetection(Protocol):
        """do_basic_crosstalk_detection on the node's circuits, one region
        per qubit."""

        def run(self, data, memlimit=None, comm=None):
            res = ProtocolResults(data, self)
            ds = data.dataset.truncate(data.edesign.all_circuits_needing_data)
            res.crosstalk = do_basic_crosstalk_detection(ds, nq, settings=[1] * nq,
                                                         confidence=0.95, verbosity=0)
            return res
    merged = data.dataset.copy()
    for c in ct_data['crosstalk'].keys():
        if c in merged:
            raise SystemExit("crosstalk: a circuit of both designs")
        merged.add_count_dict(c, dict(ct_data['crosstalk'][c].counts),
                              aux=ct_data['crosstalk'].auxInfo[c])
    top = CombinedExperimentDesign({'idt': idt_node, 'crosstalk': ct_design})
    t0 = time.time()
    tree = TreeRunner({('idt', 'design'): IdleTomography(),
                       ('crosstalk',): CrosstalkDetection()}).run(ProtocolData(top, merged))
    tree_s = time.time() - t0
    idt_tree = tree[('idt', 'design')]['IdleTomography']
    ct_tree = tree[('crosstalk',)]['CrosstalkDetection'].crosstalk
    same_idt = np.array_equal(idt_protocol_rates(idt_tree, keys),
                              idt_protocol_rates(runs['noisy'][0], keys))
    same_ct = (np.array_equal(ct_tree.cmatrix, found['crosstalk'].cmatrix)
               and ct_tree.graph.edges() == found['crosstalk'].graph.edges()
               and ct_tree.skel.edges() == found['crosstalk'].skel.edges())
    log("runners: TreeRunner over the combined design (%d circuits) in %.2f s: the idle "
        "tomography child's rates equal to the SimpleRunner run's: %s; the crosstalk child's "
        "graph and crosstalk matrix equal to the direct run's: %s; phase %.1f s"
        % (len(top.all_circuits_needing_data), tree_s, same_idt, same_ct,
           time.time() - t_phase))
    if not (same_idt and same_ct):
        raise SystemExit("runners: a TreeRunner child's result differs from its direct run")


LFH_DEV = 0.01          # phase 34: the fluctuating rates' standard deviation
LFH_ORDER = 7           # Gauss-Hermite nodes per fluctuating parameter
LFH_DRAWS = 1000        # the weak simulator's seeded draws


def h_rate_index(model, op_label, pauli):
    """The model-vector index of operation `op_label`'s 'H' rate on basis
    element `pauli`, checked by moving it alone."""
    model._rebuild_paramvec_if_needed()
    op = model.operations[op_label]
    labels = op.errorgen_coefficient_labels()
    lbl = next(l for l in labels
               if l.errorgen_type == 'H' and l.basis_element_labels[0] == pauli)
    i = op.gpindices.start + [l for l in labels if l.errorgen_type == 'H'].index(lbl)
    m = model.copy()
    v = m.to_vector()
    v[i] += 1e-3
    m.from_vector(v)
    moved = {l: abs(m.operations[op_label].errorgen_coefficients()[l]
                    - op.errorgen_coefficients()[l]) for l in labels}
    if not (moved[lbl] > 5e-4 and sum(moved.values()) - moved[lbl] < 1e-12):
        raise SystemExit("lfh: parameter %d is not %s's H(%s) rate" % (i, op_label, pauli))
    return i


def phase_lfh(mp, lists, device):
    """Phase 34: the fluctuating-Hamiltonian simulators on the card:
    smq2Q_XYICNOT 'H+s' at its target, the X 'H' rate of Gxpi2:0 and the Y
    'H' rate of Gypi2:1 fluctuating with standard deviation 0.01, over cell
    1's maxL-4 list (3,527 circuits), each simulator over one layout of
    all circuits: integrating (a 7 x 7 Gauss-Hermite grid), sigma-point
    (nested forward-mode second derivatives) and weak (1,000 seeded draws).
    At deviation 0 each equals the exact probabilities; integrating within
    5 Monte-Carlo standard errors of weak; sigma-point's gap to integrating
    fourth order in the deviation; integrating card against CPU; every
    circuit's probabilities summing to 1."""
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.extras.lfh import (GaussianParamFluctuation,
                                             LFHIntegratingForwardSimulator,
                                             LFHSigmaForwardSimulator, LFHWeakForwardSimulator)
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    t_phase = time.time()
    circuits = list(lists[2])
    model = mp.target_model('H+s')
    idx = [h_rate_index(model, Label('Gxpi2', 0), 'XI'),
           h_rate_index(model, Label('Gypi2', 1), 'IY')]

    def fluct(dev):
        return GaussianParamFluctuation({i: dev for i in idx})
    sim = SimpleForwardSimulator(model, device)
    exact = torch.as_tensor(sim.bulk_fill_probs(None, sim.create_layout(circuits)),
                            dtype=torch.float64, device=device)
    torch.cuda.reset_peak_memory_stats()
    zero = {}
    for name, s in (('integrating', LFHIntegratingForwardSimulator(model, fluct(0.0), LFH_ORDER,
                                                                   device=device)),
                    ('sigma-point', LFHSigmaForwardSimulator(model, fluct(0.0), device=device)),
                    ('weak', LFHWeakForwardSimulator(model, fluct(0.0), 10, base_seed=5,
                                                     device=device))):
        zero[name] = float((s.bulk_fill_probs(circuits)[0] - exact).abs().max())
    timings, out = {}, {}
    for name, make in (
            ('integrating', lambda dev: LFHIntegratingForwardSimulator(
                model, fluct(dev), LFH_ORDER, device=device)),
            ('sigma-point', lambda dev: LFHSigmaForwardSimulator(model, fluct(dev),
                                                                 device=device))):
        for dev in (LFH_DEV, LFH_DEV / 2):
            torch.cuda.synchronize()
            t0 = time.time()
            out[name, dev], layout = make(dev).bulk_fill_probs(circuits)
            torch.cuda.synchronize()
            timings[name, dev] = time.time() - t0
    weak = LFHWeakForwardSimulator(model, fluct(LFH_DEV), LFH_DRAWS, base_seed=5, device=device)
    torch.cuda.synchronize()
    t0 = time.time()
    p_weak, _ = weak.bulk_fill_probs(circuits)
    torch.cuda.synchronize()
    timings['weak', LFH_DEV] = time.time() - t0
    draws, _ = weak._probs_at_offsets(circuits, weak.offsets())
    peak = torch.cuda.max_memory_allocated() / 1e6
    se = draws.std(dim=0) / np.sqrt(LFH_DRAWS)
    integ = out['integrating', LFH_DEV]
    z = float(((integ - p_weak).abs() / (se + 1e-12)).max())
    gaps = [float((out['sigma-point', d] - out['integrating', d]).abs().max())
            for d in (LFH_DEV, LFH_DEV / 2)]
    ratio = gaps[0] / gaps[1]
    check = circuits[:: len(circuits) // 200][:200]
    p_cpu, _ = LFHIntegratingForwardSimulator(model, fluct(LFH_DEV), LFH_ORDER,
                                              device='cpu').bulk_fill_probs(check)
    p_card, _ = LFHIntegratingForwardSimulator(model, fluct(LFH_DEV), LFH_ORDER,
                                               device=device).bulk_fill_probs(check)
    card_cpu = float((p_card.cpu() - p_cpu).abs().max())
    sums = max(float((torch.zeros(len(circuits), dtype=torch.float64, device=device)
                      .index_add_(0, torch.as_tensor(layout.elem_circuit, device=device),
                                  p) - 1).abs().max())
               for p in (integ, out['sigma-point', LFH_DEV], p_weak))
    moved = float((integ - exact).abs().max())
    log("lfh: %d circuits, %d probabilities; parameters %s fluctuating (dev %g); at dev 0 "
        "against the exact probabilities: %s (tol 1e-12); at dev %g the probabilities move "
        "up to %.3e; integrating (%d points) against weak (%d draws): max |diff| / MC se %.2f "
        "(tol 5); sigma-point - integrating max |gap| %.3e at dev, %.3e at dev/2, ratio %.2f "
        "(fourth order: 16; held in [8, 32]); integrating card vs CPU on %d circuits %.3e "
        "(tol 1e-12); |sum - 1| max %.3e (tol 1e-12); seconds %s; peak device memory %.1f "
        "MB; phase %.1f s"
        % (len(circuits), layout.num_elements, idx, LFH_DEV,
           {k: '%.1e' % v for k, v in zero.items()}, LFH_DEV, moved, LFH_ORDER ** 2, LFH_DRAWS,
           z, gaps[0], gaps[1], ratio, len(check), card_cpu, sums,
           {'%s@%g' % k: '%.2f' % v for k, v in timings.items()}, peak, time.time() - t_phase))
    if not max(zero.values()) < 1e-12:
        raise SystemExit("lfh: a simulator at deviation 0 is not the exact probabilities")
    if not z < 5:
        raise SystemExit("lfh: integrating and weak disagree beyond 5 Monte-Carlo errors")
    if not 8 <= ratio <= 32:
        raise SystemExit("lfh: the sigma-point gap is not fourth order in the deviation")
    if not (card_cpu < 1e-12 and sums < 1e-12):
        raise SystemExit("lfh: the card disagrees with the CPU, or probabilities do not sum "
                         "to 1")


def written(write, name):
    """Write a report through `write(path)` into a temporary directory:
    (its text, its bytes, the seconds the write took)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, name)
        t0 = time.time()
        write(path)
        seconds = time.time() - t0
        with open(path) as f:
            text = f.read()
    return text, len(text.encode()), seconds


def text_writer(text):
    """A `write(path)` for `written` that writes `text`."""
    def write(path):
        with open(path, 'w') as f:
            f.write(text)
    return write


REPORT_CONFIDENCE = 95   # phase 35: the report's confidence level, %


def phase_report(results, fitted, gauged, target, mp, gx_bars, device):
    """Phase 35: the standard report of phase 3's results at full width,
    not refitted: construct_standard_report(results, confidence_level=95)
    .write_html, write_pdf and create_report_notebook; every section of the
    page, an error bar in every gate-metric cell but unitarity's and in every
    prep cell, N_sigma, the box plot's values against the final 2*DeltaLogL,
    the dependency-restricted error bar against all parameters differenced,
    the diamond norm's linearization against central differences of the
    full maximization, the report's Gauss-Newton Hessian against the
    kernel's plain version.  Returns the kernel launches of the phase."""
    import re
    from pygsti_tpu_torch.objectivefns import objectivefns as objfns
    from pygsti_tpu_torch.ops.bwd_jacobian import (bwd_jacobian_accumulate,
                                                   bwd_jacobian_accumulate_plain)
    from pygsti_tpu_torch.report import construct_standard_report, reportables
    from pygsti_tpu_torch.report.factory import create_report_notebook
    from pygsti_tpu_torch.tools.optools import entanglement_infidelity
    from pygsti_tpu_torch.tools.sdptools import diamond_norm, trace_norm_at_input
    t_phase = time.time()
    key = 'GateSetTomography'
    est = results.estimates[key]
    bwd_jacobian_accumulate.launches = 0
    report = construct_standard_report(results, "smq2Q_XYICNOT GST report",
                                       confidence_level=REPORT_CONFIDENCE)
    page, page_bytes, html_s = written(report.write_html, 'report.html')
    torch.cuda.synchronize()
    launches = bwd_jacobian_accumulate.launches
    _, pdf_bytes, pdf_s = written(report.write_pdf, 'report.pdf')
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        nb = create_report_notebook(results, os.path.join(d, 'report.ipynb'),
                                    confidence_level=REPORT_CONFIDENCE)
        nb_s = time.time() - t0
        nb_bytes = os.path.getsize(nb) + dir_bytes(os.path.join(d, 'report_results'))
        with open(nb) as f:
            nb_code = "\n".join(c['source'] for c in json.load(f)['cells']
                                if c['cell_type'] == 'code')
    log("report: write_html %.2f s (%s), %d bytes; write_pdf %.2f s, %d bytes; "
        "create_report_notebook %.2f s, %d bytes with the results it reads; kernel launches %d"
        % (html_s, ", ".join("%s %.2f s" % kv for kv in report.seconds.items()), page_bytes,
           pdf_s, pdf_bytes, nb_s, nb_bytes, launches))

    # -- sections, as the JAX package's factory would write them ------------
    model = est.models['stdgaugeopt']
    expected = ["Input summary", "Estimate: %s" % key, "Model violation",
                "Per-circuit 2&amp;Delta;log&amp;#8467; contributions",
                "Per-gate metrics vs target", "Model-level metrics",
                "Gate eigenvalues (gauge-invariant)", "Angles between rotation axes (/&pi;)",
                "Error-generator projections (logGTi)",
                "Gate decompositions &amp; Choi spectra", "SPAM metrics vs target",
                "SPAM probabilities &lt;E|&rho;&gt;", "Estimated gate matrices (pp basis)",
                "SPAM vectors", "Metadata"]
    if est.parameters.get('raw_objective_values'):
        expected.insert(3, "Fit progression (objective per stage)")
    if est.parameters.get('unmodeled_error') is not None:
        expected.insert(4, "Un-modeled error (wildcard budget)")
    if getattr(results.data.edesign, 'germs', None):
        expected.append("Germ-amplified metrics (gauge-invariant)")
    if len(model.instruments):
        expected.append("Instrument metrics vs target")
    headings = re.findall(r'<h[234]>(.*?)</h[234]>', page)
    missing = [h for h in expected if h not in headings]

    def cells(title):
        table = page[page.index(title):]
        table = table[:table.index('</table>')]
        return [re.findall(r'<td[^>]*>(.*?)</td>', row)
                for row in re.findall(r'<tr><td class="lbl">.*?</tr>', table)]

    def bar(cell):
        return float(cell.split('&plusmn;')[1]) if '&plusmn;' in cell else None

    gate_rows = cells("Per-gate metrics vs target")
    gate_bars = [[bar(c) for c in row[1:]] for row in gate_rows]
    prep_rows = [row for row in cells("SPAM metrics vs target") if row[0].startswith('prep')]
    prep_bars = [bar(c) for row in prep_rows for c in row[1:]]
    good = [b is not None and np.isfinite(b) and b > 0
            for row in gate_bars for b in row[:-1]] + \
        [b is not None and np.isfinite(b) and b > 0 for b in prep_bars]
    log("report: %d headings, the JAX factory's %d for this model all present: %s; "
        "'unavailable' %d times; per-gate table %d gates x %d metrics, error bars in %d of the "
        "%d cells that take one, unitarity's column without; prep cells with error bars %d of "
        "%d"
        % (len(headings), len(expected), not missing, page.count('unavailable'),
           len(gate_rows), len(gate_bars[0]) if gate_bars else 0,
           sum(good[:len(good) - len(prep_bars)]), len(gate_rows) * 8,
           sum(good[len(good) - len(prep_bars):]), len(prep_bars)))
    if missing or 'unavailable' in page or len(gate_rows) != len(target.operations) \
            or not all(good) or any(row[-1] is not None for row in gate_bars) \
            or not prep_bars:
        raise SystemExit("report: missing sections %s or error bars" % missing)

    # -- model violation and the box plot --------------------------------------
    mv = reportables.model_violation_table(results, key)
    nsig_cell = [row[1] for row in cells("<h3>Model violation</h3>") if 'sigma' in row[0]][0]
    box = report.box_values[key]
    box_sum = float(sum(box.values()))
    final_value = est.parameters['final_objfn_value']
    log("report: N_sigma %s in the table, est.misfit_sigma() %.6g; the box plot's %d "
        "per-circuit 2*DeltaLogL sum to %.9f against the table's %.9f (rel %.3e, tol 1e-9)"
        % (re.sub('<[^>]+>', '', nsig_cell), est.misfit_sigma(), len(box), box_sum,
           final_value, abs(box_sum - final_value) / final_value))
    if mv['n_sigma'] != est.misfit_sigma() or \
            re.sub('<[^>]+>', '', nsig_cell) != '%.3g' % est.misfit_sigma():
        raise SystemExit("report: the table's N_sigma is not the estimate's")
    if len(box) != len(results.data.edesign.circuit_lists[-1]) or \
            not abs(box_sum - final_value) <= 1e-9 * final_value:
        raise SystemExit("report: the box plot's values do not sum to the final 2*DeltaLogL")

    # -- (a) the dependency-restricted error bar --------------------------------
    crf = est.confidence_region_factories[('final iteration estimate', 'final')]
    view = crf.view(REPORT_CONFIDENCE)
    gx = next(k for k in model.operations if k == ('Gxpi2', 0))

    def ent_inf(m):
        return reportables._GateMetric(m, entanglement_infidelity, target.operations[gx].dense(),
                                       gx, m.basis)
    t0 = time.time()
    restricted = view.compute_uncertainty(ent_inf(gauged), gauged)
    t1 = time.time()
    everything = view.compute_uncertainty(lambda m: ent_inf(gauged).evaluate_nearby(m), gauged)
    t2 = time.time()
    at_fit = view.compute_uncertainty(ent_inf(fitted), fitted)
    rel_all = abs(restricted - everything) / everything
    rel_21 = abs(at_fit - gx_bars[(('Gxpi2', 0), 'approximate')]) \
        / gx_bars[(('Gxpi2', 0), 'approximate')]
    table_bar = gate_bars[[str(k) for k in model.operations].index(str(gx))][0]
    log("report: %s's entanglement infidelity, 95%% error bar by its gate's %d parameters "
        "%.9e (%.2f s) against every one of the %d differenced %.9e (%.2f s): rel %.3e (tol "
        "1e-12); the table prints %.2g; at the fitted model %.9e against phase 21's bar from "
        "the same Gauss-Newton Hessian and 'std' projection: rel %.3e (tol 1e-9)"
        % (gx, len(ent_inf(gauged).parameter_indices(gauged)), restricted, t1 - t0,
           gauged.num_params, everything, t2 - t1, rel_all, table_bar, at_fit, rel_21))
    if not (rel_all <= 1e-12 and rel_21 <= 1e-9 and '%.2g' % restricted == '%.2g' % table_bar):
        raise SystemExit("report: the dependency-restricted error bar differs")

    # -- (b) the diamond norm's linearization -------------------------------------
    cnot = next(k for k in model.operations if k == ('Gcnot', 0, 1))
    hd = reportables.HalfDiamondNorm(gauged, target, cnot)
    value = hd.evaluate(gauged)
    gap = hd.evaluate_nearby(gauged) - value
    rng = np.random.RandomState(3535)
    idx = np.arange(gauged.num_params)[gauged.operations[cnot].gpindices]
    v0, work = gauged.to_vector(), gauged.copy()
    h = 1e-5
    derivs = []
    for _ in range(3):
        u = np.zeros(len(v0))
        u[idx] = rng.randn(len(idx))
        u /= np.linalg.norm(u)
        ends = {}
        for s in (1, -1):
            work.from_vector(v0 + s * h * u)
            L = work.operations[cnot].dense() - target.operations[cnot].dense()
            _, psi = diamond_norm(L, 'pp', return_x=True)
            ends[s] = (hd.evaluate_nearby(work), 0.5 * trace_norm_at_input(L, psi, 'pp'))
        derivs.append(((ends[1][0] - ends[-1][0]) / (2 * h), (ends[1][1] - ends[-1][1]) / (2 * h)))
    worst = max(abs(a - b) / abs(b) for a, b in derivs)
    log("report: %s's half diamond norm %.9e (the polished maximum %.3e above it); along 3 "
        "seeded directions of its %d parameters the linearization's derivative against central "
        "differences (h %g) of the full maximization, polished: %s, max rel %.3e (tol 1e-3)"
        % (cnot, value, gap, len(idx), h, ["%.6e / %.6e" % d for d in derivs], worst))
    if not worst <= 1e-3:
        raise SystemExit("report: the diamond norm's linearization disagrees with the "
                         "maximization's differences")

    # -- the report's Gauss-Newton Hessian through the kernel against its plain version
    obj = crf.objective()
    with torch.no_grad():
        p = obj._fns['probs'](obj._v(None))
        hterms = obj.raw_objfn.hterms(p, *obj._data)
    objfns.bwd_jacobian_accumulate = bwd_jacobian_accumulate_plain
    try:
        H_plain = obj.weighted_gram(hterms)
    finally:
        objfns.bwd_jacobian_accumulate = bwd_jacobian_accumulate
    rel_plain = float(np.max(np.abs(crf.hessian - H_plain)) / np.max(np.abs(H_plain)))
    germs = reportables.germ_amplified_metrics_table(model, target, mp.germs())
    log("report: its Gauss-Newton Hessian [%d x %d] through the kernel (%d launches) against "
        "the plain version on the card: max rel %.3e (tol 1e-12); the pack's %d germs' "
        "amplified eigenvalue infidelities %.3e..%.3e"
        % (crf.hessian.shape[0], crf.hessian.shape[1], launches, rel_plain, len(germs),
           min(d['eigenvalue_entanglement_infidelity'] for d in germs.values()),
           max(d['eigenvalue_entanglement_infidelity'] for d in germs.values())))
    errs, ms, plain_ms, einsum_ms, bound_ms, shapes = hold_kernel_at_buckets(
        obj.layout, fitted, device, 'report')
    log("report: the kernel at the Hessian's %d bucket shapes %s with the fitted model's G: "
        "rel err f64 %.3e, f32 %.3e; %.4f ms per Jacobian (bound %.4f ms, %.1f%% of it), plain "
        "%.3f ms, einsum %.3f ms; phase %.1f s (%s)"
        % (len(shapes), shapes, errs[torch.float64], errs[torch.float32], ms, bound_ms,
           100 * bound_ms / ms, plain_ms, einsum_ms, time.time() - t_phase,
           card_name_and_limit()))
    if not (launches > 0 and rel_plain <= 1e-12):
        raise SystemExit("report: the Hessian did not go through the kernel, or disagrees "
                         "with its plain version")
    imports = re.findall(r'^(?:from|import) (\S+)', nb_code, re.M)
    if not imports or any(m.split('.')[0] != 'pygsti_tpu_torch' for m in imports):
        raise SystemExit("report: the notebook imports %s" % imports)
    return launches


def rel_max(a, b):
    """Largest |a - b| relative to the largest |b|."""
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(b)))


def phase_simulator_modes(target, fitted, ds, lists, builders, fit_value, device):
    """Phase 36: the product cache, its probabilities and 'prodjac' on
    phase 3's data and fitted point, a 'prodjac' fit, exact Hessians, and
    the mesh path on a one-rank NCCL group.  Returns the fit's launches of
    the kernel (which it must not launch)."""
    import datetime
    import socket
    import torch.distributed as dist
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.layouts.prodcache import build_element_group_tables
    from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
    from pygsti_tpu_torch.parallel.mesh import circuit_mesh
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyDesign,
                                                GSTInitialModel, GSTObjFnBuilders)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData

    final, first = list(lists[-1]), list(lists[0])
    theta = fitted.to_vector()
    v = torch.as_tensor(theta, device=device)
    steps = {}
    t_phase = time.time()

    # -- the factorization of phase 3's final layout (host) ------------------
    t0 = time.time()
    scan = SimpleForwardSimulator(fitted, device)
    layout = scan.create_layout(final, ds)
    t1 = time.time()
    fact = layout.factorization
    t2 = time.time()
    tables = build_element_group_tables(fact, 64)
    t3 = time.time()
    counts = (len(fact.levels), fact.n_cache, len(fact.a_pfx_cache), len(fact.e_sfx_cache),
              len(fact.pair_g))
    log("simulator modes: product cache of the final layout (%d circuits, %d elements): "
        "%d levels, %d cache entries, %d prefixes, %d suffixes, %d pairs (the JAX package's "
        "7 / 1,122 / 163 / 733 / 1,869); factorize %.3f s, element groups of 64 %.3f s "
        "(%d + %d groups) on the host; layout %.3f s"
        % ((len(final), layout.num_elements) + counts
           + (t2 - t1, t3 - t2, len(tables.erow_chunk_row), len(tables.pair_chunk_q), t1 - t0)))
    if counts != (7, 1122, 163, 733, 1869):
        raise SystemExit("the product cache differs from the JAX package's plan")
    steps['factorization'] = time.time() - t0

    # -- the factorized probabilities against the scan -----------------------
    t0 = time.time()
    fact_fn = SimpleForwardSimulator(fitted, device, probs_kernel='fact').probs_fn(layout)
    scan_fn = scan.probs_fn(layout)
    with torch.no_grad():
        dp = float((fact_fn(v) - scan_fn(v)).abs().max())
        fact_ms, scan_ms = cuda_time_ms(lambda: fact_fn(v), 10), cuda_time_ms(lambda: scan_fn(v), 10)
    log("simulator modes: factorized probabilities of all %d elements vs the scan: max |dp| "
        "%.3e (tol 1e-12); %.3f ms per evaluation against the scan's %.3f ms"
        % (layout.num_elements, dp, fact_ms, scan_ms))
    if not dp < 1e-12:
        raise SystemExit("the factorized probabilities disagree with the scan")
    steps['factorized probabilities'] = time.time() - t0

    # -- 'prodjac' against 'blocked' near the fitted point ---------------------
    # At the optimum J^T f is the gradient, near 0, and its rounding passes
    # 1e-10 of its largest entry (5.5e-10 in a 1-qubit rehearsal on the
    # CPU), so the four are held 1e-3 off the fitted point, along a seeded
    # random direction.
    t0 = time.time()
    near = theta + 1e-3 * np.random.RandomState(36).randn(len(theta))
    v_near = torch.as_tensor(near, device=device)
    prod, blocked = (ObjectiveFunctionBuilder('logl', jac_mode=mode).build(
        fitted, ds, final, device=device, layout=layout) for mode in ('prodjac', 'blocked'))
    args = prod._args()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res_p = prod.jtj_jtf(near) + (prod.dlsvec(near),)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e6
    res_b = blocked.jtj_jtf(near) + (blocked.dlsvec(near),)
    rels = [rel_max(a, b) for a, b in zip(res_p, res_b)]
    prod_ms = cuda_time_ms(lambda: prod._fns['jtj_jtf'](v_near, *args), 3)
    blocked_ms = cuda_time_ms(lambda: blocked._fns['jtj_jtf'](v_near, *args), 3)
    log("simulator modes: 'prodjac' vs 'blocked' 1e-3 off the fitted point (%d elements, %d "
        "parameters): lsvec %.3e, JTJ %.3e, JTf %.3e, dlsvec %.3e of their largest entries "
        "(tol 1e-9, 1e-8, 1e-10, 1e-7); at the fitted point JTf %.3e; one jtj_jtf %.2f ms "
        "against blocked's %.2f ms; peak device memory of jtj_jtf + dlsvec %.1f MB"
        % ((layout.num_elements, len(theta)) + tuple(rels)
           + (rel_max(prod.jtj_jtf(theta)[2], blocked.jtj_jtf(theta)[2]), prod_ms,
              blocked_ms, peak)))
    if not all(r < tol for r, tol in zip(rels, (1e-9, 1e-8, 1e-10, 1e-7))):
        raise SystemExit("'prodjac' disagrees with 'blocked'")
    del res_p
    objs = [ObjectiveFunctionBuilder('logl', jac_mode='prodjac').build(
        fitted, ds, first, device=dev) for dev in (device, 'cpu')]
    rel = card_vs_cpu(objs, theta)
    log("simulator modes: 'prodjac' lsvec/JTJ/JTf on the card vs the CPU path (%d circuits): "
        "max rel diff %.3e (tol 1e-12)" % (len(first), rel))
    if not rel < 1e-12:
        raise SystemExit("'prodjac' on the card disagrees with the CPU path")
    steps["'prodjac' checks"] = time.time() - t0

    # -- a GST fit through 'prodjac' ------------------------------------------
    t0 = time.time()
    prodjac_builders = GSTObjFnBuilders(
        [ObjectiveFunctionBuilder(b.name, regularization=b.regularization, jac_mode='prodjac')
         for b in builders.iteration_builders],
        [ObjectiveFunctionBuilder(b.name, regularization=b.regularization, jac_mode='prodjac')
         for b in builders.final_builders])
    gst = GateSetTomography(GSTInitialModel(model=target.copy()), gaugeopt_suite=None,
                            objfn_builders=prodjac_builders, optimizer={'maxiter': LM_MAXITER},
                            verbosity=0, device=device)
    est, launches, fit_s, iters, fit_peak = fit_launches(
        gst, ProtocolData(GateSetTomographyDesign(target, lists), ds), 'prodjac fit', lists)
    value, nsigma = est.parameters['final_objfn_value'], est.misfit_sigma()
    rel_fit = abs(value - fit_value) / abs(fit_value)
    log("simulator modes: 'prodjac' fit from the target: %d LM iterations in %.3f s, final "
        "2*DeltaLogL %.6f (phase 3's %.6f, rel diff %.3e, tol 1e-3), N_sigma %.4f, kernel "
        "launches %d (tol 0), peak device memory %.1f MB"
        % (iters, fit_s, value, fit_value, rel_fit, nsigma, launches, fit_peak))
    if not (rel_fit < 1e-3 and nsigma < 10 and launches == 0):
        raise SystemExit("the 'prodjac' fit missed phase 3's optimum or launched the kernel")
    steps["'prodjac' fit"] = time.time() - t0

    # -- exact Hessians and first derivatives against central differences ----
    t0 = time.time()
    four = final[:: len(final) // 4][:4]
    model = fitted.copy()
    sim = SimpleForwardSimulator(model, device)
    lay4 = sim.create_layout(four)
    H = sim.bulk_fill_hprobs(None, lay4)
    J = sim.bulk_fill_dprobs(None, lay4)
    scale = float(np.max(np.abs(H)))
    sym = float(np.max(np.abs(H - H.transpose(0, 2, 1)))) / scale
    rng = np.random.RandomState(36)
    eps = 1e-6
    dh, dj = 0.0, 0.0
    for _ in range(4):
        u = rng.randn(len(theta))
        u /= np.linalg.norm(u)
        side = []
        for sgn in (1, -1):
            model.from_vector(theta + sgn * eps * u)
            side.append((sim.bulk_fill_dprobs(None, lay4), sim.bulk_fill_probs(None, lay4)))
        model.from_vector(theta)
        dh = max(dh, float(np.max(np.abs((side[0][0] - side[1][0]) / (2 * eps) - H @ u))))
        dj = max(dj, float(np.max(np.abs((side[0][1] - side[1][1]) / (2 * eps) - J @ u))))
    log("simulator modes: exact Hessians of %d circuits' %d probabilities at %d parameters "
        "(max |H| %.3e): symmetric within %.3e (tol 1e-12); along 4 random directions H u "
        "vs central differences of bulk_fill_dprobs at eps 1e-6 within %.3e of max |H| "
        "(tol 1e-6), dprobs u vs central differences of probs within %.3e (tol 1e-7)"
        % (len(four), lay4.num_elements, len(theta), scale, sym, dh / scale, dj))
    if not (sym < 1e-12 and dh < 1e-6 * scale and dj < 1e-7):
        raise SystemExit("the exact Hessians or first derivatives disagree with central "
                         "differences")
    steps['Hessians'] = time.time() - t0

    # -- the mesh path on a one-rank NCCL group -------------------------------
    t0 = time.time()
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(device)
    dist.init_process_group('nccl', init_method='tcp://127.0.0.1:%d' % port, rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    mesh = circuit_mesh()
    meshed = fitted.copy()
    meshed.sim = SimpleForwardSimulator(meshed, device, mesh=mesh)
    obj_m = ObjectiveFunctionBuilder('logl').build(meshed, ds, final, device=device)
    obj_s = ObjectiveFunctionBuilder('logl', jac_mode='linearize').build(fitted, ds, final,
                                                                         device=device)
    res_m, res_s = obj_m.jtj_jtf(near), obj_s.jtj_jtf(near)
    same = all(np.array_equal(a, b) for a, b in zip(res_m, res_s))
    rels = [rel_max(a, b) for a, b in zip(res_m, res_b[:3])]
    small_m = ObjectiveFunctionBuilder('logl').build(meshed, ds, first, device=device)
    small_s = ObjectiveFunctionBuilder('logl', jac_mode='linearize').build(fitted, ds, first,
                                                                           device=device)
    x0 = target.to_vector()
    lm_m, lm_s = small_m.run_device_lm(x0, maxiter=3), small_s.run_device_lm(x0, maxiter=3)
    lm_same = np.array_equal(np.asarray(lm_m[0]), np.asarray(lm_s[0])) and lm_m[7] == lm_s[7]
    dist.destroy_process_group()
    log("simulator modes: mesh of %d rank(s) (NCCL, %s): jac_mode %r; jtj_jtf of the final "
        "list equal to the serial 'linearize' one bit for bit: %s; against blocked: lsvec "
        "%.3e, JTJ %.3e, JTf %.3e (tol 1e-9, 1e-8, 1e-10); 3 LM iterations on the first "
        "list from the target equal to the serial ones: %s (%d iterations)"
        % (mesh.size(), mesh.device_type, obj_m.jac_mode, same, rels[0], rels[1], rels[2],
           lm_same, lm_m[7]))
    if not (same and lm_same and obj_m.jac_mode == 'linearize'
            and all(r < tol for r, tol in zip(rels, (1e-9, 1e-8, 1e-10)))):
        raise SystemExit("the mesh path disagrees with the serial one")
    log("simulator modes: two ranks need two cards: the multi-rank checks are the CPU tests "
        "of tests/test_torch_multidevice.py (gloo)")
    steps['mesh'] = time.time() - t0
    log("simulator modes: seconds by step: %s; the phase %.1f s"
        % (", ".join("%s %.1f" % kv for kv in steps.items()), time.time() - t_phase))
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
                         "is false")
    sys.path.insert(0, HERE)
    import pygsti_tpu_torch
    if not os.path.abspath(pygsti_tpu_torch.__file__).startswith(HERE + os.sep):
        raise SystemExit("pygsti_tpu_torch was not found beside chip_smoke.py")
    from pygsti_tpu_torch.algorithms.core import run_lgst
    from pygsti_tpu_torch.algorithms.gaugeopt import gaugeopt_to_target
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    from pygsti_tpu_torch.modelpacks import smq2Q_XYICNOT as mp
    from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
    from pygsti_tpu_torch.ops.bwd_jacobian import bwd_jacobian_accumulate
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography, GateSetTomographyCheckpoint,
                                                GateSetTomographyDesign, GSTInitialModel,
                                                GSTObjFnBuilders)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData

    device = torch.device('cuda', 0)
    log("torch %s, CUDA %s, %s x%d; the host's CPU kernels: %s, %d threads"
        % (torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
           torch.cuda.device_count(), torch.backends.cpu.get_cpu_capability(),
           torch.get_num_threads()))
    phase_build()

    # -- the design (host): lists, target, datagen --------------------------
    t0 = time.time()
    target = mp.target_model('full')
    maxlengths = [L for L in (1, 2, 4, 8, 16, 32, 64) if L <= MAXL]
    lists = create_lsgst_circuit_lists(target, mp.prep_fiducials(), mp.meas_fiducials(),
                                       mp.germs(), maxlengths)
    final = list(lists[-1])
    log("design: %d lists, final list %d circuits, %d parameters, max depth %d (%.2f s)"
        % (len(lists), len(final), target.num_params, max(c.depth for c in final),
           time.time() - t0))
    if len(final) != 13958 or target.num_params != 1616:
        raise SystemExit("unexpected design size")
    layout = SimpleForwardSimulator(target, device).create_layout(final)

    kernel_rows = phase_kernels(layout, target, device)

    # -- the fit ------------------------------------------------------------
    datagen = mp.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01)
    t0 = time.time()
    ds = simulate_data(datagen, final, 1000, seed=1234, device=device)
    log("data: %d circuits x 1000 shots simulated on the card in %.2f s"
        % (len(ds), time.time() - t0))
    builders = GSTObjFnBuilders(
        [ObjectiveFunctionBuilder(
            'chi2', regularization={'min_prob_clip_for_weighting': MINCLIP})],
        [ObjectiveFunctionBuilder(
            'logl', regularization={'min_prob_clip': MINCLIP, 'radius': MINCLIP})])
    log("fit: LM maxiter %d per stage (the optimizer's default)" % LM_MAXITER)
    data = ProtocolData(GateSetTomographyDesign(target, lists), ds)
    gst = GateSetTomography(GSTInitialModel(model=target.copy()),
                            gaugeopt_suite='stdgaugeopt', objfn_builders=builders,
                            optimizer={'maxiter': LM_MAXITER}, verbosity=0, device=device)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bwd_jacobian_accumulate.launches = 0
    with tempfile.TemporaryDirectory() as ckdir:
        t0 = time.time()
        results = gst.run(data, checkpoint_path=os.path.join(ckdir, 'chip_smoke'))
        torch.cuda.synchronize()
        run_wall = time.time() - t0
        launches = {'bwd_jacobian': bwd_jacobian_accumulate.launches}
        ckfiles = sorted(os.listdir(ckdir))
        cksizes = [os.path.getsize(os.path.join(ckdir, f)) for f in ckfiles]
        last_ck = GateSetTomographyCheckpoint.read(
            os.path.join(ckdir, 'chip_smoke_iteration_%d.json' % (len(lists) - 1)))
    est = results.estimates['GateSetTomography']
    timers = est.parameters['profiler']
    total_iters = log_stages('fit', est, lists)
    # the window of the earlier smoke runs: the iterations alone (each LM
    # stage ends in a read of its result, so the card has finished), without
    # the checkpoint files written between them
    fit_wall = est.parameters['fit_time'] - timers['checkpoint writes']
    fit_value = est.parameters['final_objfn_value']
    dof = est.parameters['final_dof']
    nsigma = est.misfit_sigma()
    log("fit: %d LM iterations in %.3f s wall (GateSetTomography.run as a whole: %.3f s); "
        "final 2*DeltaLogL %.6f, k %d, N_sigma %.4f"
        % (total_iters, fit_wall, run_wall, fit_value, dof, nsigma))
    log("fit: kernel launches %s; peak device memory %.1f MB"
        % (launches, torch.cuda.max_memory_allocated() / 1e6))
    log("run: phase times of GateSetTomography.run (host clock):\n"
        + "\n".join("  %-40s %.3f s" % kv for kv in sorted(timers.items())))
    fitted = est.models['final iteration estimate']
    gauged = est.models['stdgaugeopt']
    for i, st in enumerate(est.parameters['gaugeopt_stats']['stdgaugeopt']):
        log("gaugeopt stage %d: %s group, %d parameters; Adam %d steps in %.3f s "
            "(%.3f ms per step); L-BFGS-B %d iterations, %d evaluations in %.3f s; "
            "objective %.9g -> %.9g"
            % (i + 1, st['group'], st['num_params'], st['adam_steps'], st['adam_s'],
               1e3 * st['adam_s'] / max(st['adam_steps'], 1), st['lbfgs_iterations'],
               st['lbfgs_evaluations'], st['lbfgs_s'], st['objective_before'],
               st['objective_after']))
        if not (np.isfinite(st['objective_after'])
                and st['objective_after'] <= st['objective_before']):
            raise SystemExit("gauge-opt stage %d ended at %r from %r"
                             % (i + 1, st['objective_after'], st['objective_before']))
    # Stage 1 weighs every element alike, so its objective is the squared
    # Frobenius distance to the target: that distance must not rise there.
    # Stages 2 and 3 weigh gates or SPAM only, and stage 3 adds the SPAM
    # positivity penalty, so the distance after all three may be larger.
    stage1 = est.parameters['gaugeopt_stats']['stdgaugeopt'][0]
    dist_before, dist_after = fitted.frobeniusdist(target), gauged.frobeniusdist(target)
    dist_stage1 = float(np.sqrt(stage1['objective_after']))
    log("gaugeopt: Frobenius distance to the target %.9g before, %.9g after stage 1, "
        "%.9g after 'stdgaugeopt'" % (dist_before, dist_stage1, dist_after))
    log("checkpoints: %d files, %s bytes" % (len(ckfiles), cksizes))
    if launches['bwd_jacobian'] == 0:
        raise SystemExit("the fit never launched the bwd_jacobian kernel")
    theta = fitted.to_vector()
    if not (np.all(np.isfinite(theta)) and np.isfinite(fit_value) and np.isfinite(nsigma)):
        raise SystemExit("non-finite fit result")
    if not nsigma < 10:
        raise SystemExit("the fit is far from the statistical optimum: N_sigma %g" % nsigma)
    if not (abs(stage1['objective_before'] - dist_before ** 2) <= 1e-9 * dist_before ** 2
            and dist_stage1 < dist_before and np.isfinite(dist_after)):
        raise SystemExit("gauge-opt stage 1 did not bring the model closer to the target")
    if len(ckfiles) != len(lists) or \
            not np.array_equal(last_ck.mdl_list[-1].to_vector(), theta):
        raise SystemExit("the last checkpoint does not read back to the final model")

    # -- checks against references on small inputs ---------------------------
    check = final[:: len(final) // 200][:200]
    check_layout = SimpleForwardSimulator(fitted, device).create_layout(check)
    p_card = SimpleForwardSimulator(fitted, device).bulk_fill_probs(None, check_layout)
    p_ref = reference_probs(fitted, check)
    dp = float(np.max(np.abs(p_card - p_ref)))
    log("check: probabilities of %d circuits vs numpy reference: max |dp| %.3e (tol 1e-10)"
        % (len(check), dp))
    if p_card.shape != p_ref.shape or not dp < 1e-10:
        raise SystemExit("probabilities disagree with the numpy reference")
    dp = float(np.max(np.abs(
        SimpleForwardSimulator(gauged, device).bulk_fill_probs(None, check_layout) - p_card)))
    log("check: probabilities of the 'stdgaugeopt' model vs the fitted model's: "
        "max |dp| %.3e (tol 1e-9: a gauge transformation changes none)" % dp)
    if not dp < 1e-9:
        raise SystemExit("gauge optimization changed the model's probabilities")
    small = list(lists[0])
    objs = [ObjectiveFunctionBuilder('logl').build(fitted, ds, small, device=dev)
            for dev in (device, 'cpu')]
    rel = card_vs_cpu(objs, theta)
    log("check: blocked lsvec/JTJ/JTf on the card vs the CPU path (%d circuits): "
        "max rel diff %.3e (tol 1e-9)" % (len(small), rel))
    if not rel < 1e-9:
        raise SystemExit("the card's Jacobian disagrees with the CPU path: max rel diff %.3e"
                         % rel)

    obj = ObjectiveFunctionBuilder('logl').build(fitted, ds, final, device=device)
    obj.jtj_jtf(theta)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        obj.jtj_jtf(theta)
        obj.lsvec(theta)
        torch.cuda.synchronize()
    log("profile: one jtj_jtf + one lsvec on the final list (%d circuits)" % len(final))
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))

    # -- the CPTP-constrained fit of the same data ----------------------------
    cptp_launches = phase_cptp_fit(mp, lists, ds, builders, fit_value, fitted, check, device)

    # -- LGST on the same data, gauge-optimized on the card -------------------
    t0 = time.time()
    lgst = run_lgst(ds, mp.prep_fiducials(), mp.meas_fiducials(), target, verbosity=2)
    t1 = time.time()
    stats = {}
    lgst_go = gaugeopt_to_target(lgst, target, device=device, stats=stats)
    t2 = time.time()
    lgst_dist = lgst_go.frobeniusdist(datagen)
    lgst_2dlogl = 2 * ObjectiveFunctionBuilder('logl').build(
        lgst_go, ds, small, device=device).fn()
    log("lgst: %d x %d fiducial pairs, %d ops: run_lgst %.3f s on the host; gaugeopt_to_target "
        "(%s group, %d parameters) %.3f s on the card (Adam %.3f ms per step), objective "
        "%.6g -> %.6g; Frobenius "
        "distance to the data-generating model %.6g; 2*DeltaLogL on the first list "
        "(%d circuits) %.6g"
        % (len(mp.prep_fiducials()), len(mp.meas_fiducials()), len(target.operations),
           t1 - t0, stats['group'], stats['num_params'], t2 - t1,
           1e3 * stats['adam_s'] / stats['adam_steps'], stats['objective_before'],
           stats['objective_after'], lgst_dist, len(small), lgst_2dlogl))
    if not (np.isfinite(lgst_dist) and np.isfinite(lgst_2dlogl) and lgst_dist <= 0.5):
        raise SystemExit("LGST is not finite or far from the data-generating model")
    # what one gauge-opt step costs the card against what it costs the host
    pstats = {}
    with torch.profiler.profile(activities=acts) as prof:
        gaugeopt_to_target(lgst, target, device=device, maxiter=100, stats=pstats)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    evals = pstats['adam_steps'] + pstats['lbfgs_evaluations'] + 1
    log("profile: gaugeopt_to_target (%s group, %d parameters), %d Adam steps + %d L-BFGS-B "
        "evaluations: the card busy %.3f ms in %d kernel launches (%.4f ms and %.0f launches "
        "per evaluation of value and gradient); unprofiled, an Adam step took %.3f ms of "
        "wall time in the run above, so the card was busy %.1f%% of it"
        % (pstats['group'], pstats['num_params'], pstats['adam_steps'],
           pstats['lbfgs_evaluations'], busy_ms, sum(e.count for e in kernels),
           busy_ms / evals, sum(e.count for e in kernels) / evals,
           1e3 * stats['adam_s'] / stats['adam_steps'],
           100 * (busy_ms / evals) / (1e3 * stats['adam_s'] / stats['adam_steps'])))

    # -- the fit with a mid-circuit measurement, then sparse outcomes --------
    t0 = time.time()
    inst_launches = phase_instrument_fit(mp, lists, datagen, builders, device)
    t1 = time.time()
    phase_sparse(datagen, fitted, ds, lists, device)
    t2 = time.time()
    log("phases 8 and 9: %.1f s and %.1f s of the script's wall time" % (t1 - t0, t2 - t1))

    # -- parallel layers, then the fiducial-pair-reduced design --------------
    par_launches, _ = phase_parallel_fit(builders, device)
    t3 = time.time()
    fpr_launches = phase_fpr_fit(mp, target, ds, final, builders, device)
    t4 = time.time()
    log("phases 10 and 11: %.1f s and %.1f s of the script's wall time" % (t3 - t2, t4 - t3))

    # -- the qutrit pack, robust phase estimation, the other objectives -------
    qutrit_launches, _ = phase_qutrit_fit(builders, device)
    t5 = time.time()
    phase_rpe(device)
    t6 = time.time()
    obj_launches = phase_objectives(target, lists, ds, est, fit_value, device)
    t7 = time.time()
    log("phases 12, 13 and 14: %.1f s, %.1f s and %.1f s of the script's wall time"
        % (t5 - t4, t6 - t5, t7 - t6))

    # -- implicit models: the 5-qubit cloud-noise cell, a 2-qubit cloud fit,
    # -- the state-vector simulator
    cloud_launches = implicit_phases(device)

    # -- randomized benchmarking, then the 3-qubit blocked fit ---------------
    cloud3_launches = rb_and_cloud3_phases(device)

    # -- error bars, bad-fit handling and Fisher information at full width ----
    stat_launches, gx_bars = phase_statistics(mp, est, target, datagen, lists, builders, device)
    gx_bar95 = gx_bars[(('Gxpi2', 0), 'exact')]

    # -- data in and out, the one-call driver, the bootstrap -----------------
    driver_launches, boot_launches = phase_data_io(mp, target, lists, ds, fitted, fit_value,
                                                   nsigma, datagen, gx_bar95, device)

    # -- design selection at full width, then error-generator propagation ----
    selection_launches = phase_design_selection(datagen, device)
    phase_errgen_propagation()

    # -- mirror benchmarks at 4 qubits, then the Taylor-term simulator --------
    t8 = time.time()
    phase_mirror(device)
    t9 = time.time()
    phase_term_simulator(lists, device)
    t10 = time.time()
    log("phases 25 and 26: %.1f s and %.1f s of the script's wall time" % (t9 - t8, t10 - t9))

    # -- time-resolved GST, then drift detection and data comparison ---------
    td_launches = phase_time_resolved_fit(mp, lists, device)
    t11 = time.time()
    phase_drift_detection(mp, lists, device)
    t12 = time.time()
    log("phases 27 and 28: %.1f s and %.1f s of the script's wall time"
        % (t11 - t10, t12 - t11))

    # -- FOGI at 2 qubits, then leakage GST of one qubit ---------------------
    fogi_launches = phase_fogi_fit(mp, lists, builders, device)
    t13 = time.time()
    leak_launches = phase_leakage_fit(builders, device)
    t14 = time.time()
    log("phases 29 and 30: %.1f s and %.1f s of the script's wall time"
        % (t13 - t12, t14 - t13))

    # -- the report quantities of phase 3's estimate ------------------------
    report_launches = phase_report_quantities(target, datagen, fitted, gauged, ds, lists,
                                              device)
    t15 = time.time()
    log("phase 31: %.1f s of the script's wall time" % (t15 - t14))

    # -- an interpolated-gate fit, idle tomography and crosstalk through the
    # -- runners, the fluctuating-Hamiltonian simulators
    interp_launches = phase_interpolated_fit(mp, lists, builders, device)
    t16 = time.time()
    phase_idt_crosstalk(device)
    t17 = time.time()
    phase_lfh(mp, lists, device)
    t18 = time.time()
    log("phases 32, 33 and 34: %.1f s, %.1f s and %.1f s of the script's wall time"
        % (t16 - t15, t17 - t16, t18 - t17))

    # -- the standard report of phase 3's results, with error bars -----------
    report_kernel_launches = phase_report(results, fitted, gauged, target, mp, gx_bars, device)
    t19 = time.time()
    log("phase 35: %.1f s of the script's wall time" % (t19 - t18))

    # -- the product cache, 'prodjac', exact Hessians and the mesh path ------
    prodjac_launches = phase_simulator_modes(target, fitted, ds, lists, builders, fit_value,
                                             device)
    t20 = time.time()
    log("phase 36: %.1f s of the script's wall time; the script %.1f s (%s)"
        % (t20 - t19, t20 - T_START, card_name_and_limit()))

    r64 = kernel_rows[torch.float64]
    log(json.dumps({"kernels": [{
        "name": "bwd_jacobian", "route": "cuda",
        "source": "pygsti_tpu_torch/csrc/bwd_jacobian.cu",
        "replaces": "pygsti_tpu/ops/pallas_kernels.py:84",
        "launches": launches['bwd_jacobian'] + cptp_launches + inst_launches + par_launches
        + fpr_launches + qutrit_launches + sum(obj_launches.values()) + cloud_launches
        + cloud3_launches + stat_launches + driver_launches + boot_launches
        + selection_launches + td_launches + sum(fogi_launches.values())
        + sum(leak_launches.values()) + report_launches + interp_launches
        + report_kernel_launches + prodjac_launches,
        "launches_by_path": dict({"full fit": launches['bwd_jacobian'],
                                  "cptp fit": cptp_launches, "instrument fit": inst_launches,
                                  "parallel-layer fit": par_launches, "fpr fit": fpr_launches,
                                  "qutrit fit": qutrit_launches}, **obj_launches,
                                 **{"cloud-noise fit": cloud_launches,
                                    "3-qubit cloud-noise fit": cloud3_launches,
                                    "statistics": stat_launches,
                                    "driver fit": driver_launches,
                                    "bootstrap": boot_launches,
                                    "design-selection fit": selection_launches,
                                    "time-resolved fit": td_launches}, **fogi_launches,
                                 **leak_launches, **{"jacobian check": report_launches,
                                                     "interpolated-gate fit": interp_launches,
                                                     "report": report_kernel_launches,
                                                     "prodjac": prodjac_launches}),
        "max_abs_err": r64['max_abs'], "ms": r64['ms'], "plain_ms": r64['plain_ms'],
        "bound_ms": r64['bound_ms'], "bound_by": r64['bound_by'],
        # no single PyTorch call computes this function; the batched-einsum
        # formulation is reported beside it as a yardstick only
        "library_ms": None, "einsum_yardstick_ms": r64['einsum_ms']}]}))
    log(card_name_and_limit())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
