#!/usr/bin/env python3
"""Drive the PyTorch port of the VBN serving path on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. build: compile ``vectorizedbayesiannetwork_torch/csrc/*.cu`` with nvcc
   (sm_90a) and print the build seconds, ptxas' registers and spills of
   every kernel (a spill fails the run), and a count of the SASS
   instructions (``cuobjdump``) of the sweep kernels, the cumsum's two
   passes, the merge kernel and the KDE log-density kernels;
2. fit: the asia network (8 categorical nodes) and the 3-node
   linear-Gaussian flagship, each on 4096 rows, on the card;
3. kernels: each sweep kernel against its plain PyTorch version at B=8,
   S=2^16 in every ``want`` mode, on the same external uniforms and on the
   in-kernel grouped Philox stream; then ``vbn_lg_sweep`` against
   ``vbn_lg_scan`` bit for bit on the flagship's static plan, both fed the
   same external uniforms and each on its own in-kernel stream
   (``lg_scan_matches_unrolled``);
4. main path: ``infer_posterior_pmf`` (asia, likelihood weighting) and
   ``infer_posterior_moments`` (flagship, Monte-Carlo marginalization) at
   B=1024 query rows and S=2^20 particles, with the launch counters reset
   just before and read just after; the asia pmf is held against the exact
   posterior of the fitted CPTs, the flagship moments against their closed
   form;
5. timing: each kernel's ms at the main-path shapes and ``want`` mode
   (CUDA events), held once more against its plain version over the same
   batch and in-kernel Philox draws (the plain version runs B_PLAIN rows
   at a time and is timed over the whole batch), the operation/byte bound,
   and the end-to-end queries/s of both workloads (12 batches per window,
   best of 5 windows).

Then the mask-dynamic slice, on two large networks at full width: the
link-scale categorical network (``random_bn_treewidth(724)``, LW pmf) and
the arth150-scale linear-Gaussian one (``random_gaussian(107)``, LW
moments), each fitted on 4096 rows and served 96 heterogeneous single-row
queries at S=2^20 with ``dynamic_masks=True``:

6. scan_kernel_check: ``vbn_cat_scan`` against its plain version bit for
   bit (streams; reductions within 2e-4) at B=8, S=2^16 in every ``want``
   mode, on external uniforms and its grouped Philox stream, on the
   724-node network, a network with up to 80 classes and asia's static
   plan; ``vbn_lg_scan`` within its tolerances on the 107-node one, on
   external uniforms and its grouped stream (two nodes a Philox call); and
   ``vbn_cat_scan`` against ``vbn_cat_sweep`` bit for bit on asia's static
   plan, both fed the same external uniforms and each on its own in-kernel
   stream;
7. dynamic_main_path: ``infer_posterior_pmf`` on the 96 link-scale queries
   and ``infer_posterior_moments`` on the 96 LG queries, each with the
   launch counters reset just before and read just after; pmf rows held
   against the exact posterior of the fitted CPTs (median KL), moments
   against the fitted network's closed form; peak device memory;
8. dynamic_streams (S=2^16): ``infer_posterior_many`` with LW and MCM on 8
   link-scale queries, one launch each, and one static 724-node LW query
   through the static plan's scan route;
9. scan timing: each scan kernel's ms at the main-path shape, the plain
   version's over the same batch (SCAN_PLAIN_ROWS rows a call, held
   against the kernel on every row), the bound, each scan kernel's block
   size, carveout and blocks an SM, the end-to-end queries/s of both
   workloads and a profiled batch of each.

Then the resampling slice (resampled and plain importance sampling):

10. resample_kernels: ``vbn_cumsum``, ``vbn_cum_index`` (the merge's tile
    pointer routine on its own entry point), ``vbn_srg`` and ``vbn_spg``
    against their plain versions at B=8, S=2^16 and S=2^20 on
    six weight profiles quantized to multiples of 2^-23 (D=1, 3 and 5;
    ``vbn_spg`` at S_out = S/2, S and 2S; exact), the high-u0 case and
    multinomial order statistics (exact), and at S=2^22 on unquantized
    weights, where ``norm_cum`` takes the monotone cumsum and both merges
    read the kernel's CDF (D=1, 3 and 5; exact given it);
11. ris_main_path: RIS on the flagship diagnosis query (x0 | x2, B=8) at
    S=2^20 systematic, S=2^20 multinomial and S=2^22 systematic, each with
    the counters reset just before and read just after (one resampling
    event: one ``cumsum`` and one ``srg``, or two ``cumsum`` and one
    ``spg``; no ``cum_index``: the merge derives its tile pointers), moments
    against the closed form, peak memory;
12. ris_asia: asia P(lung | xray, dysp), B=8, S=2^20, ess_threshold 0.99
    (two events, the first over 3 live nodes), pmf against the exact
    posterior of the fitted CPTs;
13. is_main_path: flagship diagnosis IS at B=8, S=2^20, and IS with
    ``dynamic_masks=True`` on the 96 link-scale queries at S=2^16 (two scan
    launches: the IS sweep and its per-row LW fallback);
14. resample_timing: each resampling kernel held exactly against its plain
    version at B=8, S=2^20 (D=1, and D=3 for ``vbn_srg``; ``vbn_cumsum``
    also on multinomial's [B, S+1] Exp draws), then its device ms there
    (``torch.profiler`` events under the kernels' names: these kernels are
    shorter than their wrappers' host path) beside the wrapper's
    CUDA-event ms (``wrapper_ms``), its plain version's and one PyTorch
    call's, the byte bound, the merge's grid, the monotone pass's cost, RIS
    and IS queries/s, and a profiled RIS batch.

Then the KDE slice (KDE CPDs, max_points 2048 and Scott bandwidths, the
``vbn_kde_lw_dyn`` preset's fit):

15. kde_kernels: ``vbn_kde_root``, ``vbn_kde_cond``, ``vbn_kde_cond_wide``
    and ``vbn_kde_pick`` against their plain versions at M=2^14 rows, N=2048
    and 2000 (its last 300 points masked), Dx in {1, 2}, Dp in {0, 1, 2, 3,
    40}: log-densities within 1e-4, picks exact with an external Gumbel
    field, and on the served inverse-CDF route the plain version's pick on
    >= 99.99 % of 2^20 rows (any other a neighbour in the walk); the pick
    statistics over 2^20 draws (a flat mask uniform and a conditional pick
    the exact categorical within 6 sd by chi-square, a 0.75/0.25 two-point
    mask); ``vbn_kde_cond_wide`` with wide targets at Scott bandwidths,
    queries one bandwidth off the support in every feature and queries far
    off it (log-densities past 100, ``far_queries``), within 1e-4 (and both
    it and the plain version against float64, logged);
16. kde_main_path: the KDE flagship (all three nodes KDE, 4096 rows): W1 LW
    x2 | x0 and W2 LW x0 | x2 (B=8, S=2^20), and MCM x2 | x0, x1, each with
    the counters reset just before and read just after, each held within
    0.05 sd of a float64 reference of the fitted model; W1's peak memory;
17. kde_dynamic: W3, ``random_gaussian(8)`` fitted on 4096 rows, 96 queries
    as one ``dynamic_masks=True`` batch at S=2^16, KL against the exact
    posterior (median <= 0.02, mean <= 0.1);
18. kde_wide: W4, a KDE node with 40 parent features (LW t | y, B=8,
    S=2^16), which launches ``vbn_kde_cond_wide``, held against its plain
    version on that launch's own inputs;
19. kde_timing: each KDE kernel's ms at its workload's shape, its plain
    version's over all of that launch's rows (held against the kernel
    there; picks on >= 99.99 % of rows) and one library composition's
    (``torch.cdist`` with ``torch.logsumexp``, or with Gumbel noise and
    ``argmax``) over all of them, 2^16 rows a call; the bound of the
    function (SFU exps at 16 a clock per SM; for the pick, one draw a row
    from its categorical; the feature multiply-adds at the TF32 tensor
    rate); the root pick's own ms and bound; W1-W4 queries/s and profiled
    W1, W2, W3 and W4 batches.

Then the exact engines, which run no hand kernel (plain torch on the card):

20. exact_main_path: ``categorical_exact`` on asia P(dysp | smoke, asia)
    at B=1024 (joint-state enumeration) and on 96 queries each of insurance
    and alarm (``benchmarking/midsize.py:128,135``; the queries of
    ``generate_inference_queries(bn, 96, seed=0)``; junction tree), pmf
    rows within 1e-5 of variable elimination on the fitted CPTs;
    ``gaussian_exact`` on the flagship at B=1024 and gauss107's 96 queries
    (closed-form conditioning, float32 matmuls without TF32), moments
    within 1e-4 of the posterior std of the fitted network's float64 closed
    form; each with the counters reset just before and read just after (no
    launch), queries/s (best of 3 windows), peak memory and a profiled
    batch.

Then the neural CPDs, whose MLP products are torch's (no hand kernel of
their own; RIS over them launches the resampling kernels):

21. neural_main_path: first the bf16 product (bf16 inputs, float32 out
    through ``torch.mm(..., out_dtype=)``); (a) tpu_study.py's
    configuration 2, ``gaussian_nn`` x0, x1 and ``mdn`` x2 (3 components,
    30 epochs, batch 1024, lr 1e-2) on the flagship's rows, x0 | x2 =
    linspace(-1, 1, 8) by IS at S=2^18 and RIS at S=2^20 (one
    ``vbn_cumsum`` and one ``vbn_srg`` launch), each (mean, std) within
    0.05 std of a float64 grid over (x0, x1) of the fitted model; (b) W3's
    network and 96 queries with ``gaussian_nn`` and ``mdn`` (5 components;
    the ``vbn_gnn_lw_dyn`` / ``vbn_mdn_lw_dyn`` fit) and ``rff_gaussian``
    (256 features), LW ``dynamic_masks=True`` at S=2^16, KL to the true
    posterior logged, and ``gaussian_exact`` on the ``gaussian_nn`` fit;
    (c) asia with ``categorical_embedded_softmax`` (``vbn_emb_lw``), its
    mean KL to the true CPTs within 2x ``categorical_table``'s + 1e-3, and
    (d) tpu_study.py's discretized flagship with ``softmax_nn`` (8
    classes): LW pmf rows (B=8, S=2^20) within 5e-3 of
    ``categorical_exact`` on the same model; each fit's seconds per node
    and per optimizer step, device launches per step, and every family on
    the card against the CPU over 2^16 rows (float32 within 1e-5 of scale;
    bf16 within rtol 0.05, atol 0.15), each served batch with the counters
    reset just before and read just after.

Then sampling and the online update policies (the samplers and policies
are torch ops, the KDE paths run the KDE kernels):

22. sampling_main_path: (s1) ancestral over (d)'s ``softmax_nn`` network,
    x2 with no evidence, 2^20 draws, the class histogram against
    ``categorical_exact``'s marginal by a merged chi-square z (<= 6);
    (s2) Gibbs over the KDE flagship (max_points 2048) at W2's query
    (x0 | x2 = linspace(-1, 1, 8); 256 draws, burn-in 20, 64 chains;
    ``tpu_study.py:179-192``), launching ``vbn_kde_pick`` and
    ``vbn_kde_cond``, means within 5 standard errors (64 chains' batch
    means) and stds within 15 % of W2's float64 reference, and a profiled
    call; (s3) Gibbs on the LG flagship, x2 | x0 = 0.5, one chain of 1024
    draws (burn-in 50, thinning 5; ``gibbs_micro.py``) on the hoisted and
    the keyed noise route, each against ``gaussian_exact``; (s4) HMC and
    NUTS on the LG flagship as ``tests/test_sampling.py`` sets them (x0 |
    x2 = 0.5, 400 draws, burn-in 50, step 0.2, 8 chains, 8 leapfrogs; NUTS
    at most depth 6, and adapting from a step of 5) against
    ``gaussian_exact``, then HMC and NUTS over the KDE flagship at W2's
    query (64 chains) against its reference, launching ``vbn_kde_root`` and
    ``vbn_kde_cond`` in every gradient evaluation, and the KDE
    log-density's autograd.Function on the card against autograd of the
    plain version (2^14 rows, within 1e-5 of the gradient's scale); each
    with the counters reset just before and read just after, ms, draws/s,
    leapfrogs and device kernels a transition, and peak memory;
23. update_main_path (u1): ms per update call of r2_measure.py's four
    workloads (LG ``streaming_stats``, 8192 fit rows; ``gaussian_nn``
    ``online_sgd`` and ``ema``, 4096; ``categorical_table``
    ``streaming_stats``, 8 classes; 1024 update rows) and KDE
    ``streaming_stats`` on the flagship (max_points 2048, the Gumbel top-k
    route), each first update of a fresh fit held against the same update
    on the CPU (closed forms within 1e-5, counts exactly, neural on full
    batches within 1e-5 of scale; KDE as a uniform subset of the pool).

Then the grouped neural fit, LBP, Rao-Blackwellized marginalization and
the amortizer (torch ops; LBP and RBM over KDE run the KDE kernels):

24. (g1) the star z -> y0..y3 of ``tests/test_fit_grouping.py`` on 4096
    rows, ``gaussian_nn`` at its default widths and fit budget, with
    ``VBN_FIT_GROUP=always`` against ``never`` (fit s, ms and device
    launches a loop step; the grouped params within rtol 2e-3 / atol 2e-4
    of the sequential ones); (g2) phase 21's (b) gauss8 ``gaussian_nn``
    fit grouped and sequential (the groups formed, fit s, the 96-query LW
    dynamic KL of each); (l1) LBP on the flagship's diagnosis query (B=8,
    S=2^20; ``sync_fix_study.py``), (mean, std) within 0.05 std of the
    closed form, the smoothing steps and the fallback logged; (l2) LBP
    over the KDE flagship at W2's query, within 0.05 std of its float64
    reference, launching ``vbn_kde_pick`` and ``vbn_kde_cond``; (r1) RBM on
    the flagship's x2 | x0, x1 (B=8, 512 grid points, 2^18 particles;
    ``tpu_study.py``), the grid's mean and std within 1e-4 std of the
    closed form; (r2) RBM over the KDE flagship at W1's query (S=2^20),
    which falls back to LW as the JAX package does (``vbn_kde_root``,
    ``vbn_kde_pick``), within 0.05 std of W1's reference; (r3) RBM on asia
    (``presets.py`` ``vbn_ct_rao``, B=1024), and its pmf at 2^18 particles
    within 5e-3 of ``categorical_exact``; (a1) the amortizer of
    ``tests/test_amortized.py`` (fit s and steps, serving q/s at B=1024,
    the JAX test's limits, its categorical pmf within 0.1, heads on the
    card within 1e-5 of scale of the CPU's); each served path with the
    counters reset just before and read just after, queries/s and a
    profiled batch.

Then devices, the relative query and the stacked-table sweeps (torch ops
around the sweep kernels; the stacked forms run no hand kernel):

25. (t1) asia fitted on the CPU, moved by ``to_device("cuda")`` and served
    by LW pmf at B=1024, S=2^20 (one ``vbn_cat_sweep``), within 5e-3 of
    the exact posterior of the fitted CPTs; saved, reloaded by
    ``VBN.load(path, map_location="cuda")`` and served at the same key
    counter: the same rows bit for bit; (t4) ``utils.profiling.timed_call``
    and a ``StageTimer`` around one more batch, the kernels' build
    directory (``core/cache.py``), and no matplotlib imported; (t2)
    ``infer_relative`` on the flagship by MCM (x2 | x0, x1 against the
    no-evidence reference, B=1024, S=2^20): one ``infer_posterior_many``
    call, statically one ``vbn_lg_sweep`` launch (the reference's; the
    query, every parent observed, is MCM's direct CPD evaluation) and with
    ``dynamic_masks`` one fused ``vbn_lg_scan`` for both,
    ``delta_mean`` within 5 standard errors of the closed form of the
    fitted params, queries/s; (t3) ``random_bn_treewidth(2048)`` (LW pmf,
    ``link_queries``' 96) and ``random_gaussian(2048)`` (LW moments, 96
    queries), S=2^14, ``dynamic_masks=True``, which the scan kernels
    refuse (``n_nodes 2048 > 1500``), each under
    ``VBN_DISCRETE_SCAN=auto`` (the stacked-table form) and ``never``
    (the per-node loop; one batch of it on the categorical plan, whose
    per-node draws take ``torch.cumsum`` over 4-class rows): the route
    taken, queries/s, peak memory, and a profiled batch (device kernels a
    batch, busy ms, the longest ops, idle share); the categorical rows'
    median KL to variable elimination <= 2e-3; the
    Gaussian rows' median |Δmean| and |Δstd| within 0.05 std of
    ``gaussian_exact`` on the fitted params, and every row within 5
    standard errors of its LW estimate (at S=2^14 a row's ESS falls to a
    few hundred, one standard error several hundredths of the std). Each
    stacked form draws a chunk of nodes a ``vbn_uniforms`` launch: against
    one node a launch (the parent commit's draws) at one key counter, its
    rows bit for bit, launches a batch, and queries/s in turns.

Then the ('data', 'particle') mesh over ``torch.distributed``:

26. (m1) ``initialize_distributed()`` and ``make_mesh()`` in this process
    (a one-rank NCCL group), ``set_mesh`` on the phase-2 models, and phase
    4's two cells through the public entry points (one ``vbn_cat_sweep``
    and one ``vbn_lg_sweep``, read around each call), held to phase 4's
    limits; queries/s by phase 5's windows, unmeshed and meshed in turns;
    ``set_mesh(None)`` then serves phase 4's rows again bit for bit at
    their key counters. (m2) two spawned ranks on the one card over gloo,
    meshes (1, 2) and (2, 1): each rank loads the models of phases 2 and
    7 saved by ``VBN.save`` with ``map_location="cuda"`` and the kernels
    this process built, and serves asia LW pmf and flagship MCM moments
    (B=1024, S=2^20), the link-scale LW pmf and gauss107 LW moments (96
    queries, ``dynamic_masks=True``, S=2^20), RIS systematic and
    multinomial on the diagnosis query (B=8, S=2^20, ESS threshold 0.99;
    one ``vbn_cumsum`` (two) and a ``vbn_spg`` a ring step) and the fit
    steps on 2^20 rows, each call's launches read on each rank; the rows
    are held to phases 4 and 7's limits, RIS to 0.05 std of the closed
    form, the ridge fit within 1e-4 and the Adam step within 1e-5 of
    scale of m1's one-rank steps, and the two ranks' results equal. On
    (1, 2) every kernel path is also fed external uniforms (B=8,
    S=2^16): the ranks' blocks concatenated and fed to one unmeshed launch
    give equal streams and combined reductions within 2e-4 (pmf) and 2e-3
    (moments). Per-rank and total queries/s are two ranks sharing one
    card, no scaling figure. (m3) t3's stacked categorical form (the
    2048-node plan, its first 8 queries, S=2^14, LW dynamic pmf) sharded
    over 'particle' (``ops/sweep.py::shard_trace``): on the one-rank NCCL
    mesh in this process, and on (1, 2) in each of m2's two ranks; meshed
    and unmeshed in turns, the rows and streams bit for bit, a rank's peak
    memory (under the unmeshed one's on (1, 2)) and queries/s of each,
    and the unmeshed rows again from one node a ``vbn_uniforms`` launch,
    bit for bit; its launches (``vbn_uniforms``), with the chain samplers'
    of s2 and s4, are the kernel line's ``launches`` of row 13. (m2)'s
    ranks also run the chain samplers on each mesh (``m2_chains``): Gibbs
    over asia's tables and the LG flagship, HMC and NUTS on the flagship
    at a fixed and an adapted step (8 rows of 8 chains, rows over 'data',
    chains over 'particle'), meshed against unmeshed bit for bit on each
    rank and equal across ranks; 3 chains do not split and run whole.

Then the row stream of the torch-op sweeps (before phase 26):

27. ``vbn_uniforms`` against its plain version (int64 torch ops on the
    card) at W1's [8, 2^20] and t3's [96, 2^14] rows, one node a launch
    and (t3) 64: uniforms bit for bit (one and four values a particle, a
    block off the origin), normals within 2e-6 of |z| + 1; the wrapper's
    ms and the kernel's device ms (a CUDA graph of launches between
    events) beside the plain version's and ``torch.rand``'s of the same
    numel; the bound priced by instruction
    class at Hopper's issue rates, and the kernel's SASS mix
    (``cuobjdump``) that it prices. Then row-0 batch invariance on the
    card at key counter 500, a batch of two against a batch of one, for W1
    (KDE LW), (b) gauss8 ``gaussian_nn`` LW dynamic, t3's stacked form (8
    queries), IS and RIS systematic on the diagnosis query: weights within
    1e-6, samples bit for bit; and the chain samplers (``row0_samplers``):
    Gibbs, HMC and NUTS on the LG flagship at a fixed step and HMC over the
    KDE flagship at W2's query, samples bit for bit. Every torch-op phase
    above reads ``vbn_uniforms`` among its launches (at least one).
28. level_group (run right after the neural phase, whose models it
    serves, while the profiler still records device events): three static
    plans served under ``VBN_LEVEL_GROUP``
    never and auto in turns (never, auto, auto, never): the star of the
    JAX grouping test with ``gaussian_nn`` siblings at full width (LW t |
    z, B=8, S=2^18), (a)'s neural flagship by IS (the roots one group) and
    (c)'s asia ``categorical_embedded_softmax`` LW (tub, lung, bronc one
    group): queries/s, ``vbn_uniforms`` launches a batch (one a group
    grouped, one a node ungrouped), the groups, a profiled batch of each
    mode; grouped against ungrouped at one key counter at the JAX grouping
    test's tolerances, and (a), (c) against their phase limits.
29. torch routes (after phase 27, before phase 26): each kernel against
    the torch route it stands in for, the torch route called directly
    (``serve_torch_routes``; the port has no route switch): asia LW and
    flagship MCM of x2 | x0 (B=8, S=2^20), the served call against the torch-op
    sweep on the same plan and key stream; flagship RIS's resampling event
    ([8, 2^20] x 3), ``vbn_cumsum`` + ``vbn_srg`` against the index form
    of ``ops/resample.py``; W1's x2 pick, ``vbn_kde_pick`` against the
    chunked inverse-CDF form on the kernel's uniforms. Each: the launches
    of a call of each route (the torch route's kernels 0), the answers
    held (class frequencies 5e-3, moments 0.05 std, row means of the
    picks 0.01), calls/s in turns (kernel, torch, torch, kernel) and a
    profiled call of each.

30. mlp_fused (right after the neural phase): ``vbn_gauss_mlp``
    (``csrc/mlp.cu``), a ``gaussian_nn`` node's whole served forward in
    one launch, against the plain route (``_denorm_params`` ->
    ``mlp_apply``) on the card at 2^20 and 96 x 2^20 rows (the gnn cell's
    call) for 1, 2 and 3 parents, seeded random weights and statistics:
    loc within 1e-5 of ``std_y``, scale within 1e-5 relative; at 2^20
    also with the softplus inputs past its threshold of 20, and against
    its plain version (``gauss_mlp_plain``) at the same limits; a served
    draw and log-density launching it twice (``LAUNCHES["gauss_mlp"]``)
    and counted in ``MLP["fused"]`` and ``MLP["fused_rows"]``; the row's
    launches those of (b)'s served batch (``neural_gauss8``: two a
    ``gaussian_nn`` node with parents), and phase 28's star counts them
    ungrouped (one a sibling) and grouped (none: the vmapped forward takes
    the plain route); at 96 x 2^20 the kernel's ms (CUDA events, a
    warm-up then 5 runs) beside the plain route's (``library_ms``), the
    plain version's over the whole batch in chunks, and the bound by
    ``vbnbench``'s count of the forward's operations at the published
    peaks.
31. node_planes (right after phase 30): the per-node dynamic sweep's
    target read at the gnn cell's shape (96 x 2^20, 8 one-dim nodes, one
    target a row drawn at random): the packed route (the nodes' [B, S,
    1] values concatenated into [B, S, 8], then
    ``packed_target_values``) against the node-major store's gather
    (``_dynamic_sweep.py::dynamic_target_values`` over [8, B, S]), the
    target blocks equal bit for bit; ms of each (CUDA events, a warm-up
    then one call, in turns packed, planes, planes, packed, five rounds;
    medians), of the concatenation alone and of the gnn network's parent
    concatenations (3, 3, 2 and 1 parents), and the gather's bound by
    its bytes.

Prints a JSON line of kernel results (the twelve kernels,
``vbn_uniforms`` and ``vbn_gauss_mlp``, its launches in (t3) and phase 28 as ``launches_t3``
and ``launches_level_group_<plan>``; rows 9, 10 and
12 with their launches in (l2) and (r2) as ``launches_l2`` and
``launches_r2``, rows 1 and 2 with theirs in (t1) and (t2) as
``launches_t1`` and ``launches_t2``, rows 1-5 and 8 with theirs in (m1)
and (m2), summed over ranks and meshes, as ``launches_m1`` and
``launches_m2``; row 13's ``launches`` is (m3)'s one-rank batch, its
chain draws under ``launches_sampling_main_path`` and
``launches_row0_chains``), the card's name and power limit,
and last
``{"ok": true, "device": {...}}``. Any failure
exits nonzero. The script imports nothing of JAX or of the JAX package.

``python3 chip_smoke.py --parent DIR`` also times, before those last lines,
the kernel of another checkout's port package at DIR (for example the
parent commit's ``vectorizedbayesiannetwork_torch/``, unpacked with ``git
archive`` into a directory ``.gitignore`` lists) beside this one's, in
turns in one process (``compare_builds``): ``vbn_uniforms`` at W1's [8,
2^20] and for 64 nodes at t3's [96, 2^14] (device and wrapper ms, the
builds equal bit for bit; a build that draws one node a launch timed over
its 64 launches), the queries/s of flagship RIS systematic and
multinomial, W1's KDE LW and flagship IS; then (``compare_samplers``) the
chain samplers at s2-s4's sizes, ten rounds of each build (s2 Gibbs over
KDE, ms a draw; s3 hoisted Gibbs, ms a step; s4 HMC and NUTS on the LG
flagship and HMC over KDE, ms a transition) and five of (t3)'s LG
per-node loop (ms a 96-query batch), medians, minima and maxima.
"""

from __future__ import annotations

import json
import re
import subprocess
from collections import Counter
import sys
import time
import types

import numpy as np

B_MAIN = 1024
S_MAIN = 1 << 20
B_CHECK, S_CHECK = 8, 1 << 16
B_PLAIN = 8  # rows per plain-version call: it makes [B, S] tensors per node
REPS = 12
WINDOWS = 5
PEAK_OPS = 67e12  # H100 SXM float32 outside the tensor cores, op/s
PEAK_TF32 = 495e12  # H100 SXM dense TF32 on the tensor cores, flop/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, byte/s
PEAK_SFU = 132 * 16 * 1.98e9  # H100 SXM special-function results (exp, log), /s
N_DYN = 96  # heterogeneous single-row queries per served batch
S_STREAMS = 1 << 16  # depth of the dynamic_streams phase
SCAN_PLAIN_ROWS = 2  # rows per call of a scan plain version at full width
SCAN_REPS = 3  # kernel launches per CUDA-event window
SCAN_WINDOWS = 3  # served batches timed end to end, best of
B_RIS, S_RIS, S_RIS_BIG = 8, 1 << 20, 1 << 22  # the RIS workload (tpu_study.py)
S_IS_DYN = 1 << 16  # IS dynamic_masks on the link-scale queries
RIS_REPS = 5  # launches per CUDA-event window of a resampling kernel
PROFILES = ["dirichlet", "uniform", "last", "first", "alternate", "mixed"]
CAT_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("pmf_logw",),
             ("pmf_lpt",), ("mom_logw",), ("mom_lpt",)]
LG_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("mom_logw",),
            ("mom_lpt",)]


def log(tag: str, **kv) -> None:
    print(json.dumps({"phase": tag, **kv}), flush=True)


def fit_discrete(vbn_cls, defaults, bn, seed=0, device=None):
    """The port's fit of a discrete network on 4096 rows of its data."""
    from benchmarking.data_gen import generate_dataset

    data = generate_dataset(bn, 4096, seed=seed)
    vbn = vbn_cls({n: bn.parents[n] for n in bn.nodes}, seed=seed,
                  device=device)
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    vbn.set_learning_method("node_wise", nodes_cpds=conf)
    vbn.fit({k: np.asarray(v, np.float32).reshape(-1, 1) for k, v in data.items()})
    return vbn


def fit_asia(vbn_cls, defaults):
    from benchmarking.networks import asia

    bn = asia()
    return bn, fit_discrete(vbn_cls, defaults, bn)


def flagship_data(n=4096, seed=0):
    """The flagship's rows (``__graft_entry__.py:18-38``): x2 = 0.5 x0 -
    0.2 x1 + 0.1 noise."""
    g = np.random.default_rng(seed)
    x0 = g.normal(size=n)
    x1 = g.normal(size=n)
    x2 = 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)
    return {"x0": x0, "x1": x1, "x2": x2}


def fit_flagship(vbn_cls, defaults, n=4096, seed=0):
    vbn = vbn_cls([("x0", "x2"), ("x1", "x2")], seed=seed)
    vbn.set_learning_method(
        "node_wise",
        nodes_cpds={k: defaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")},
    )
    vbn.fit(flagship_data(n, seed))
    return vbn


def asia_query(b):
    return {
        "target": "dysp",
        "evidence": {
            "smoke": (np.arange(b) % 2).reshape(b, 1).astype(np.float32),
            "asia": ((np.arange(b) // 2) % 2).reshape(b, 1).astype(np.float32),
        },
    }


def flagship_query(b):
    return {
        "target": "x2",
        "evidence": {
            "x0": np.linspace(-1, 1, b).reshape(b, 1).astype(np.float32),
            "x1": np.linspace(1, -1, b).reshape(b, 1).astype(np.float32),
        },
    }


def kernel_inputs(vbn, query, lg: bool):
    """(fixed tensor, table, plan_tuple[, dmax]) for the query's plan, as
    ``make_fused_sweep_fn`` builds them on the main path."""
    import torch

    from vectorizedbayesiannetwork_torch.core.plan import get_plan, pack_fixed_values
    from vectorizedbayesiannetwork_torch.ops import sweep

    q = vbn._normalize_query(query)
    plan = get_plan(vbn, q)
    cpds = tuple(vbn.cpd_spec(n) for n in plan.topo_order)
    params = tuple(vbn.params[n] for n in plan.topo_order)
    b = next(iter(q.evidence.values())).shape[0]
    fixed = torch.as_tensor(pack_fixed_values(q, plan, b, clamp_obs=not lg),
                            device=vbn.device)
    if lg:
        plan_struct, dmax = sweep.lg_plan_tuple_for(plan, cpds)
        ptab = sweep.lg_param_table(
            cpds, params, dmax, tuple(c.min_scale for c in cpds)
        )
        return fixed.contiguous(), ptab, plan_struct, dmax
    plan_tuple = sweep.plan_tuple_for(plan, cpds)
    counts = sweep._stacked_counts(cpds, params, plan_tuple[1], plan_tuple[2])
    return fixed.round().to(torch.int32), counts, plan_tuple[0], None


def compare(name, got, want, *, atol=None, rtol=None, exact=False):
    import torch

    err = float((got.double() - want.double()).abs().max())
    if exact:
        ok = bool(torch.equal(got, want))
    else:
        ok = bool(torch.allclose(got.double(), want.double(),
                                 atol=atol or 0.0, rtol=rtol or 0.0))
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} (atol {atol}, rtol {rtol})")
    return err


def served_rows(kind, sums):
    """What a user gets from reduction sums: normalized pmf rows, or
    (mean, std) rows from (sum w, sum w x, sum w x^2)."""
    import torch

    sums = sums.double()
    if kind == "pmf":
        return sums / sums.sum(1, keepdim=True)
    mean = sums[:, 1] / sums[:, 0]
    var = torch.clamp(sums[:, 2] / sums[:, 0] - mean * mean, min=0.0)
    return torch.stack([mean, var.sqrt()], 1)


def compare_red(name, got, want, kind, *, rtol, shift_atol):
    """Kernel vs plain reduction ``(sums, m)``: the shifts within
    ``shift_atol``, each sum within ``rtol`` of its row's largest sum (a
    moment sum may cancel to near 0, so the scale is the row's, not the
    entry's); returns the max abs error of the served rows."""
    compare(f"{name} shift", got[1], want[1], atol=shift_atol)
    scale = want[0].double().abs().max(1, keepdim=True).values
    err = (got[0].double() - want[0].double()).abs() / scale
    if not bool((err <= rtol).all()):
        raise AssertionError(f"{name} sums: max err {float(err.max())} of the "
                             f"row scale > rtol {rtol}")
    return float((served_rows(kind, got[0]) - served_rows(kind, want[0]))
                 .abs().max())


def check_outputs(tag, k_out, p_out, want, *, tgt_atol, lp_atol):
    """Streams within the tolerances (classes exact when tgt_atol is 0),
    reductions as ``compare_red``; returns the max abs error."""
    err = 0.0
    for label, kk, pp in zip(("logw", "tgt", "lpt"), k_out[:3], p_out[:3]):
        if (kk is None) != (pp is None):
            raise AssertionError(f"{tag} {label}: outputs differ in presence")
        if kk is not None:
            err = max(err, compare(
                f"{tag} {label}", kk, pp, exact=label == "tgt" and tgt_atol == 0,
                atol=tgt_atol if label == "tgt" else lp_atol))
    if k_out[3] is not None:
        kind = next(w for w in want if "_" in w).split("_")[0]
        err = max(err, compare_red(tag, k_out[3], p_out[3], kind,
                                   rtol=2e-4 if kind == "pmf" else 2e-3,
                                   shift_atol=lp_atol))
    return err


def check_kernels(asia_vbn, lg_vbn):
    """Kernel vs plain version at B_CHECK x S_CHECK; returns max abs err
    per kernel."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import sweep

    errs = {"categorical": 0.0, "lg": 0.0}
    dev = asia_vbn.device
    gen = torch.Generator(device=dev).manual_seed(1234)
    fixed, counts, plan_struct, _ = kernel_inputs(asia_vbn, asia_query(B_CHECK), False)
    n = plan_struct[0]
    u = torch.rand((B_CHECK, n, S_CHECK), generator=gen, device=dev)
    u = u.clamp(1e-6, 1 - 1e-6)
    modes = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("pmf_logw",),
             ("pmf_lpt",), ("mom_logw",), ("mom_lpt",)]
    for want in modes:
        for u_ext in (u, None):
            k_out = sweep.categorical_sweep_fused(
                77, fixed, counts, plan_struct, S_CHECK, u_ext=u_ext, want=want)
            p_out = sweep.categorical_sweep_plain(
                77, fixed, counts, plan_struct, S_CHECK, u_ext=u_ext, want=want)
            torch.cuda.synchronize()
            tag = f"categorical {want} {'u_ext' if u_ext is not None else 'philox'}"
            errs["categorical"] = max(errs["categorical"], check_outputs(
                tag, k_out, p_out, want, tgt_atol=0, lp_atol=1e-4))
            log("kernel_check", kernel="vbn_cat_sweep", want=list(want),
                uniforms="u_ext" if u_ext is not None else "philox", ok=True)

    fixed, ptab, plan_struct, dmax = kernel_inputs(lg_vbn, flagship_query(B_CHECK), True)
    n = plan_struct[0]
    u = torch.rand((B_CHECK, 2 * n, S_CHECK), generator=gen, device=dev)
    u = u.clamp(1e-6, 1 - 1e-6)
    modes = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("mom_logw",), ("mom_lpt",)]
    for want in modes:
        for u_ext in (u, None):
            k_out = sweep.lg_sweep_fused(
                78, fixed, ptab, plan_struct, dmax, S_CHECK, u_ext=u_ext, want=want)
            p_out = sweep.lg_sweep_plain(
                78, fixed, ptab, plan_struct, dmax, S_CHECK, u_ext=u_ext, want=want)
            torch.cuda.synchronize()
            tag = f"lg {want} {'u_ext' if u_ext is not None else 'philox'}"
            errs["lg"] = max(errs["lg"], check_outputs(
                tag, k_out, p_out, want, tgt_atol=2e-4, lp_atol=2e-3))
            log("kernel_check", kernel="vbn_lg_sweep", want=list(want),
                uniforms="u_ext" if u_ext is not None else "philox", ok=True)
    return errs


def check_lg_sweep_matches_scan(lg_vbn):
    """vbn_lg_sweep against vbn_lg_scan bit for bit on the flagship's
    static plan (x2 | x0, x1) at B_CHECK x S_CHECK: both fed the same
    external uniforms (the grouped Philox stream), and each on its own
    in-kernel stream."""
    import torch

    from vectorizedbayesiannetwork_torch.core.plan import get_plan
    from vectorizedbayesiannetwork_torch.core.rng import philox_uniforms
    from vectorizedbayesiannetwork_torch.ops import sweep, sweep_scan

    q = flagship_query(B_CHECK)
    plan = get_plan(lg_vbn, lg_vbn._normalize_query(q))
    cpds = tuple(lg_vbn.cpd_spec(n) for n in plan.topo_order)
    params = tuple(lg_vbn.params[n] for n in plan.topo_order)
    fixed, ptab, st, dmax = kernel_inputs(lg_vbn, q, True)
    dev = fixed.device
    flags = (torch.tensor(plan.evidence_mask, device=dev).int()
             | (torch.tensor(plan.do_mask, device=dev).int() << 1)
             ).expand(B_CHECK, -1).contiguous()
    tgt = torch.full((B_CHECK,), plan.target_idx, dtype=torch.int32, device=dev)
    struct = sweep_scan.lg_scan_struct_for(plan, cpds)
    args = (fixed, flags, tgt, sweep_scan.lg_ptab_flat(cpds, params, struct[2]),
            struct, S_CHECK)
    want = ("logw", "tgt", "lpt")
    u = philox_uniforms(32, B_CHECK, plan.n_nodes, S_CHECK, 2, dev, grouped=True)
    a = sweep.lg_sweep_fused(32, fixed, ptab, st, dmax, S_CHECK, u_ext=u,
                             want=want)
    b = sweep_scan.lg_sweep_scan(32, *args, u_ext=u, want=want)
    c = sweep_scan.lg_sweep_scan(32, *args, want=want)
    d = sweep.lg_sweep_fused(32, fixed, ptab, st, dmax, S_CHECK, want=want)
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(x, y)) for k, x, y in zip(want, a[:3], b[:3])}
    same_stream = {k: bool(torch.equal(x, y)) for k, x, y in zip(want, b[:3], c[:3])}
    same_in_kernel = {k: bool(torch.equal(x, y))
                      for k, x, y in zip(want, c[:3], d[:3])}
    log("lg_scan_matches_unrolled", network="flagship", seed=32,
        uniforms="philox_uniforms(words=2, grouped=True) as u_ext", equal=same,
        in_kernel_stream_equal=same_stream,
        in_kernel_streams_of_both_equal=same_in_kernel)
    if not all(same.values()) or not all(same_stream.values()) \
            or not all(same_in_kernel.values()):
        raise AssertionError(f"vbn_lg_scan != vbn_lg_sweep bitwise: {same}, "
                             f"in-kernel stream: {same_stream}, both in-kernel: "
                             f"{same_in_kernel}")


def fitted_discrete_bn(bn, vbn, floor=0.0):
    """DiscreteBN whose CPTs are the port's normalized counts, each entry
    at least ``floor``."""
    from benchmarking.bif import DiscreteBN

    fit = DiscreteBN(name=f"{bn.name}_fitted")
    for node in vbn.dag.topological_order():
        cnt = vbn.params[node]["counts"][0].double().cpu().numpy()
        cpt = np.maximum(cnt / cnt.sum(axis=-1, keepdims=True), floor)
        cards = tuple(bn.card(p) for p in vbn.dag.parents(node))
        fit.nodes.append(node)
        fit.states[node] = bn.states[node]
        fit.parents[node] = list(vbn.dag.parents(node))
        fit.cpts[node] = cpt.reshape(cards + (cpt.shape[-1],))
    fit.validate()
    return fit


def asia_pmf_error(bn, vbn, qa, pmf):
    """Max abs error of asia's pmf rows against the exact posterior of the
    fitted CPTs (the 4 evidence patterns of ``asia_query``)."""
    from benchmarking.exact import exact_posterior

    pmf = pmf / pmf.sum(axis=1, keepdims=True)
    fit = fitted_discrete_bn(bn, vbn)
    ev = qa["evidence"]
    err = 0.0
    for r in range(4):
        exact = exact_posterior(fit, "dysp", {
            "smoke": int(ev["smoke"][r, 0]), "asia": int(ev["asia"][r, 0])})
        err = max(err, float(np.abs(pmf[r::4] - exact[None]).max()))
    return err


def serve_main_path(bn, asia_vbn, lg_vbn):
    """Phase 4. Returns the launches and, for phase 26, each workload's key
    counter and rows: (launches, {"asia": (counter, pmf), "flagship":
    (counter, moments)})."""
    reset_launches()
    qa = asia_query(B_MAIN)
    asia_at = asia_vbn._keys.state()
    pmf, spans = asia_vbn.infer_posterior_pmf([qa], n_classes=2)
    path_asia = asia_vbn._last_summary_path
    ql = flagship_query(B_MAIN)
    lg_at = lg_vbn._keys.state()
    mom, _ = lg_vbn.infer_posterior_moments([ql])
    path_lg = lg_vbn._last_summary_path
    from vectorizedbayesiannetwork_torch.ops._launch import LAUNCHES

    launches = dict(LAUNCHES)
    log("main_path", launches=launches, path_asia=path_asia, path_lg=path_lg)
    if launches["categorical"] < 1 or launches["lg"] < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if path_asia != "fused" or path_lg != "fused":
        raise AssertionError(f"summary paths {path_asia}, {path_lg} != fused")
    main_path_accuracy("main_path_accuracy", bn, asia_vbn, lg_vbn, pmf, mom)
    return launches, {"asia": (asia_at, pmf), "flagship": (lg_at, mom)}


def main_path_accuracy(tag, bn, asia_vbn, lg_vbn, pmf, mom):
    """Holds asia's pmf rows (``asia_query(B_MAIN)``) to the exact posterior
    of the fitted CPTs (5e-3) and the flagship's moments
    (``flagship_query(B_MAIN)``) to their closed form (1e-3); logs and
    returns the errors."""
    qa, ql = asia_query(B_MAIN), flagship_query(B_MAIN)
    if pmf.shape != (B_MAIN, 2) or not np.isfinite(pmf).all():
        raise AssertionError(f"{tag}: asia pmf rows bad: {pmf.shape}")
    err_asia = asia_pmf_error(bn, asia_vbn, qa, pmf)
    p = lg_vbn.params["x2"]
    w = p["weight"][:, 0].double().cpu().numpy()
    sigma = float(np.sqrt(max(float(p["var"][0]), lg_vbn.nodes["x2"].min_scale ** 2)))
    mean_cf = ql["evidence"]["x0"][:, 0] * w[0] + ql["evidence"]["x1"][:, 0] * w[1] \
        + float(p["bias"][0])
    if mom.shape != (B_MAIN, 2) or not np.isfinite(mom).all():
        raise AssertionError(f"{tag}: flagship moments rows bad: {mom.shape}")
    errs = {"asia_pmf_max_abs_err": err_asia,
            "flagship_mean_max_abs_err": float(np.abs(mom[:, 0] - mean_cf).max()),
            "flagship_std_max_abs_err": float(
                np.abs(mom[:, 1] - sigma / np.sqrt(2.0)).max())}
    log(tag, **errs)
    if err_asia > 5e-3:
        raise AssertionError(f"{tag}: asia pmf off the exact posterior by {err_asia}")
    if errs["flagship_mean_max_abs_err"] > 1e-3 or \
            errs["flagship_std_max_abs_err"] > 1e-3:
        raise AssertionError(f"{tag}: flagship moments off closed form: {errs}")
    return errs


def graph_ms(fn, reps):
    """Device ms a call of ``fn``: ``reps`` calls captured in one CUDA graph
    (kernels launched on the current stream are captured, host work is
    not), the graph replayed three times between CUDA events. For kernels
    shorter than their wrapper's host path, where events around the calls
    time the host, and where the profiler records no device events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (3 * reps)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cat_cost(plan_struct, counts, b, s, want, k):
    """(operations, bytes) of one categorical sweep call's function,
    counting each integer, float and transcendental instruction as one
    operation: per latent node one 32-bit random word, a quarter of a
    Philox-4x32-10 call (10 rounds of 2 mul.lo, 2 mul.hi, 4 xor, 2 key adds:
    100 a call, 25 a word), and the uniform (3), so 28, the parent row (2
    per parent), the class total (c-1), the threshold (1) and the walk
    (3(c-1));
    per fixed node the row and total; 5 per weighted node (div, 2 max, log,
    add); per particle the reduction (3 + 2K for a histogram, 3 + 5 for
    moments). Bytes: each input read once, each output written once."""
    from vectorizedbayesiannetwork_torch.ops import sweep

    n, parent_idx, ev, do, t, _offs, _ps, cards, _st = plan_struct
    rows, cmax = counts.shape
    red = next(w for w in want if "_" in w)
    per = 0
    for i in range(n):
        c, npar = cards[i], len(parent_idx[i])
        per += 2 * npar + (c - 1)
        if not (ev[i] or do[i]):
            per += 28 + 1 + 3 * (c - 1)
        if (ev[i] and red.endswith("logw")) or (i == t and red.endswith("lpt")):
            per += 5
    per += 3 + (2 * k if red.startswith("pmf") else 5)
    nblk = s // (sweep._THREADS * sweep._ppt(s))  # blocks per row
    meta = 4 * n + 1 + 2 * sum(len(p) for p in parent_idx)
    nbytes = 4 * (b * n + rows * cmax + meta + b * nblk * (k + 1))
    return per * b * s, nbytes


def lg_cost(plan_struct, dmax, b, s, want):
    """(operations, bytes) of one LG sweep call's function, counted as
    ``cat_cost``: per latent node two 32-bit random words (a quarter Philox
    call and the uniform each: 56), Box-Muller (6: log, mul, sqrt, mul,
    cos, mul), the location (2 per parent, then 2); 8 per weighted node; 8
    per particle for the moments."""
    from vectorizedbayesiannetwork_torch.ops import sweep

    n, parent_idx, ev, do, t = plan_struct
    red = next(w for w in want if "_" in w)
    per = 0
    for i in range(n):
        per += 2 * len(parent_idx[i])
        if not (ev[i] or do[i]):
            per += 56 + 6 + 2
        if (ev[i] and red.endswith("logw")) or (i == t and red.endswith("lpt")):
            per += 8
    per += 8
    nblk = s // (sweep._THREADS * sweep._lg_ppt(s))  # blocks per row
    meta = 2 * n + 1 + sum(len(p) for p in parent_idx)
    nbytes = 4 * (b * n + n * (dmax + 2) + meta + b * nblk * 4)
    return per * b * s, nbytes


def at_main_shape(kernel, plain, kind, *, rtol, shift_atol):
    """Time ``kernel()`` (the wrapper at the main-path shapes, CUDA events),
    then the plain version over the same batch, B_PLAIN rows at a time
    (``plain(r0, r1)`` reproduces the kernel's Philox draws for rows
    r0..r1-1), timed once over the whole batch, and hold the two
    reductions against each other. Returns (ms, plain_ms, served-row max
    abs err)."""
    import torch

    ms = cuda_ms(kernel, 5)
    got = kernel()[3]
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    parts = [plain(r, min(r + B_PLAIN, B_MAIN))[3]
             for r in range(0, B_MAIN, B_PLAIN)]
    t1.record()
    torch.cuda.synchronize()
    want = (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
    err = compare_red(f"{kind} at B={B_MAIN} S={S_MAIN}", got, want, kind,
                      rtol=rtol, shift_atol=shift_atol)
    return ms, t0.elapsed_time(t1), err


def bound(cost):
    """(bound ms, what bounds it) of ``cost``, (operations, bytes),
    (operations, bytes, SFU operations) or (operations, bytes, SFU
    operations, tensor-core flops): the largest of the operations at
    PEAK_OPS, the SFU operations (exp, log) at PEAK_SFU, the flops that
    multiply-adds the tensor cores could take at PEAK_TF32, and the bytes
    at PEAK_BYTES."""
    ops, nbytes, *extra = cost
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    for n, peak in zip(extra, (PEAK_SFU, PEAK_TF32)):
        t_ops = max(t_ops, n / peak * 1e3)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_row(name, replaces, launches, err, ms, plain_ms, cost,
               source="vectorizedbayesiannetwork_torch/csrc/sweep.cu",
               library_ms=None):
    """One entry of the kernel line; ``cost`` as ``bound`` takes it."""
    ops, nbytes, *extra = cost
    bound_ms, bound_by = bound(cost)
    row = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, "ops": ops,
        "bytes": nbytes,
    }
    for key, n in zip(("sfu_ops", "tf32_flops"), extra):
        row[key] = n
    return row


def time_kernels(asia_vbn, lg_vbn, launches, errs):
    """Each kernel at the main path's shapes, in its main-path ``want``
    mode and in-kernel Philox mode, against its plain version."""
    from vectorizedbayesiannetwork_torch.core.rng import philox_uniforms
    from vectorizedbayesiannetwork_torch.ops import sweep

    fixed, counts, st, _ = kernel_inputs(asia_vbn, asia_query(B_MAIN), False)
    want = ("pmf_logw",)
    ms, plain_ms, err = at_main_shape(
        lambda: sweep.categorical_sweep_fused(
            5, fixed, counts, st, S_MAIN, want=want),
        lambda r0, r1: sweep.categorical_sweep_plain(
            5, fixed[r0:r1], counts, st, S_MAIN, want=want,
            u_ext=philox_uniforms(5, r1 - r0, st[0], S_MAIN, 1, fixed.device,
                                  row0=r0, grouped=True)),
        "pmf", rtol=2e-4, shift_atol=1e-4)
    log("kernel_main_shape", kernel="vbn_cat_sweep", ms=ms, plain_ms=plain_ms,
        served_row_max_abs_err=err)
    k = st[7][st[4]]
    cat = kernel_row(
        "vbn_cat_sweep", "vectorizedbayesiannetwork_tpu/ops/sweep_pallas.py:207",
        launches["categorical"], max(errs["categorical"], err), ms, plain_ms,
        cat_cost(st, counts, B_MAIN, S_MAIN, want, k))

    fixed, ptab, st, dmax = kernel_inputs(lg_vbn, flagship_query(B_MAIN), True)
    want = ("mom_lpt",)
    ms, plain_ms, err = at_main_shape(
        lambda: sweep.lg_sweep_fused(
            6, fixed, ptab, st, dmax, S_MAIN, want=want),
        lambda r0, r1: sweep.lg_sweep_plain(
            6, fixed[r0:r1], ptab, st, dmax, S_MAIN, want=want,
            u_ext=philox_uniforms(6, r1 - r0, st[0], S_MAIN, 2, fixed.device,
                                  row0=r0, grouped=True)),
        "mom", rtol=2e-3, shift_atol=2e-3)
    log("kernel_main_shape", kernel="vbn_lg_sweep", ms=ms, plain_ms=plain_ms,
        served_row_max_abs_err=err)
    lg = kernel_row(
        "vbn_lg_sweep", "vectorizedbayesiannetwork_tpu/ops/sweep_pallas.py:514",
        launches["lg"], max(errs["lg"], err), ms, plain_ms,
        lg_cost(st, dmax, B_MAIN, S_MAIN, want))
    return [cat, lg]


def end_to_end_qps(serve, batch):
    """queries/s: REPS batches per window, best of WINDOWS windows."""
    serve()
    serve()
    qps = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        serve()  # fetches the rows to the host: synchronous
        qps.append(batch * REPS / (time.perf_counter() - t0))
    return max(qps), qps


# ---------------------------------------------------------------------------
# The mask-dynamic slice: large networks on the scan kernels
# ---------------------------------------------------------------------------


def reset_launches():
    from vectorizedbayesiannetwork_torch.ops._launch import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0


SOME = "some"  # read_launches: the kernel launched at least once


def read_launches(expect):
    """The counters since the last reset; fails unless exactly the kernels
    in ``expect`` ran, as many times as it says (``SOME``: at least once;
    the torch-op sweeps launch ``vbn_uniforms`` once a drawn node, a
    count their routes decide). The ``<kernel>.flagged`` counts (KDE
    launches with a read flag) are held only where ``expect`` names
    them."""
    from vectorizedbayesiannetwork_torch.ops._launch import LAUNCHES

    got = {k: v for k, v in LAUNCHES.items()
           if not k.endswith(".flagged") or k in expect}
    want = {k: expect.get(k, 0) for k in got}
    some = [k for k, v in want.items() if v == SOME]
    if any(got[k] < 1 for k in some) or \
            {k: v for k, v in got.items() if k not in some} != \
            {k: v for k, v in want.items() if k not in some}:
        raise AssertionError(f"launches {got} != {want}")
    return got


def as_query(target, evidence, do=None):
    def col(v):
        return np.full((1, 1), float(v), np.float32)

    return {"target": target,
            "evidence": {n: col(v) for n, v in evidence.items()},
            "do": {n: col(v) for n, v in (do or {}).items()}}


def link_queries(bn):
    """The 96 heterogeneous queries of benchmarking/linkscale_1m.py:55-78:
    a random target and 2 evidence nodes with random values each, seed 7
    (that script skips a query whose exact posterior fails; none does on
    this network)."""
    rng = np.random.default_rng(7)
    nodes = list(bn.nodes)
    out = []
    while len(out) < N_DYN:
        t = nodes[int(rng.integers(0, len(nodes)))]
        pool = [n for n in nodes if n != t]
        evn = [pool[int(i)] for i in rng.choice(len(pool), 2, replace=False)]
        out.append((t, {n: int(rng.integers(0, bn.card(n))) for n in evn}))
    return out


def gauss_queries(gbn):
    """96 single-row queries on the LG network: a random target and 1-2
    evidence nodes each, their values from one ancestral draw of the
    network (seed 7)."""
    rng = np.random.default_rng(7)
    draw = gbn.sample(1, seed=7)
    nodes = list(gbn.nodes)
    out = []
    for _ in range(N_DYN):
        t = nodes[int(rng.integers(0, len(nodes)))]
        pool = [n for n in nodes if n != t]
        evn = [pool[int(i)]
               for i in rng.choice(len(pool), int(rng.integers(1, 3)),
                                   replace=False)]
        out.append((t, {n: float(draw[n][0]) for n in evn}))
    return out


def hetero_queries(bn, b, seed):
    """b queries mixing a target, two evidence nodes and one do node each."""
    rng = np.random.default_rng(seed)
    nodes = list(bn.nodes)
    out = []
    for _ in range(b):
        t, e1, e2, d = (nodes[int(i)]
                        for i in rng.choice(len(nodes), 4, replace=False))
        out.append(as_query(
            t, {e: int(rng.integers(0, bn.card(e))) for e in (e1, e2)},
            {d: int(rng.integers(0, bn.card(d)))}))
    return out


def fit_gaussian(vbn_cls, defaults, gbn):
    vbn = vbn_cls({n: gbn.parents[n] for n in gbn.nodes}, seed=0)
    vbn.set_learning_method(
        "node_wise",
        nodes_cpds={n: defaults.cpd("linear_gaussian") for n in gbn.nodes})
    vbn.fit(gbn.sample(4096, seed=0))
    return vbn


def fitted_gaussian_bn(vbn):
    """GaussianBN with the port's fitted weights, biases and
    sigma = sqrt(max(var, min_scale^2))."""
    from benchmarking.gaussian_bn import GaussianBN

    fit = GaussianBN(name="fitted")
    for node in vbn.dag.topological_order():
        p = vbn.params[node]
        fit.nodes.append(node)
        fit.parents[node] = list(vbn.dag.parents(node))
        fit.weights[node] = p["weight"][:, 0].double().cpu().tolist()
        fit.bias[node] = float(p["bias"][0])
        fit.sigma[node] = float(np.sqrt(max(float(p["var"][0]),
                                            vbn.nodes[node].min_scale ** 2)))
    return fit


def link_exact(bn, vbn, queries):
    """The exact posterior of each query on the fitted CPTs with every
    entry floored at 1e-12 (see ``link_accuracy``)."""
    from benchmarking.exact import exact_posterior, min_fill_order

    fit = fitted_discrete_bn(bn, vbn, floor=1e-12)
    order = min_fill_order(fit)
    return [np.asarray(exact_posterior(fit, t, ev, elim_order=order))
            for t, ev in queries]


def link_accuracy(bn, vbn, queries, pmf, spans, gts=None):
    """KL(exact || served) and max abs error of each served pmf row, the
    exact posterior taken on the fitted CPTs with every entry floored at
    1e-12, the samplers' own clamp (log max(p, 1e-12)): a class the 4096
    rows never show has probability 0 under the fitted CPTs (``prior:
    global``), and evidence on it would leave the exact posterior
    undefined. ``zero_evidence`` counts the queries with an evidence value
    that some row of its fitted CPT gives probability 0. ``gts``:
    ``link_exact``'s rows, when already taken."""
    raw = fitted_discrete_bn(bn, vbn)
    zero = sum(
        any(float(raw.cpts[n][..., v].min()) == 0.0 for n, v in ev.items())
        for _t, ev in queries)
    if gts is None:
        gts = link_exact(bn, vbn, queries)
    kls, errs = [], []
    for (lo, _hi, _t), gt in zip(spans, gts):
        r = pmf[lo][: len(gt)].astype(np.float64)
        r = r / max(r.sum(), 1e-30)
        kls.append(float(np.sum(gt * np.log(np.maximum(gt, 1e-12)
                                            / np.maximum(r, 1e-12)))))
        errs.append(float(np.abs(r - gt).max()))
    return {"kl_median": float(np.median(kls)), "kl_max": float(max(kls)),
            "max_abs_err": float(max(errs)), "zero_evidence": zero}


def gauss_accuracy(vbn, queries, mom, spans):
    """Worst |d mean| / std and |d std| / std of the served rows against
    the fitted network's closed-form posterior."""
    fit = fitted_gaussian_bn(vbn)
    worst = {"dmean_over_std": 0.0, "dstd_over_std": 0.0, "row": None}
    for (lo, _hi, _t), (t, ev) in zip(spans, queries):
        mean, std = fit.conditional(t, ev)
        dm = abs(float(mom[lo, 0]) - mean) / std
        ds = abs(float(mom[lo, 1]) - std) / std
        if max(dm, ds) > max(worst["dmean_over_std"], worst["dstd_over_std"]):
            worst["row"] = {"target": t, "evidence": ev, "mean": mean,
                            "std": std, "served": mom[lo].tolist()}
        worst["dmean_over_std"] = max(worst["dmean_over_std"], dm)
        worst["dstd_over_std"] = max(worst["dstd_over_std"], ds)
    return worst


def scan_inputs(vbn, queries):
    """(plan, cpds, params, fixed, ev, do, tgt) of the canonical plan, the
    rows packed as the main path packs them (pack_dynamic_inputs)."""
    import torch

    from vectorizedbayesiannetwork_torch.inference._dynamic_base import (
        pack_dynamic_inputs,
    )

    method = vbn._inference
    plan = method._canonical_plan(vbn)
    inputs, _spans, _b, _bp = pack_dynamic_inputs(
        plan, [vbn._normalize_query(q) for q in queries],
        clamp_obs=method.pack_clamp_obs, pad_to=len(queries))
    fixed, ev, do, tgt = (torch.as_tensor(a, device=vbn.device) for a in inputs)
    return (plan, tuple(vbn.cpd_spec(n) for n in plan.topo_order),
            tuple(vbn.params[n] for n in plan.topo_order), fixed, ev, do, tgt)


def plain_for(want, ref, k_pmf):
    """The plain version's outputs for ``want`` from its full streams
    ``ref`` (it computes the same streams whatever ``want`` asks, and
    reduces them with ``_reduce_plain``), so one plain run serves every
    ``want`` mode."""
    from vectorizedbayesiannetwork_torch.ops import sweep

    logw, tgt, lpt = ref[:3]
    want_logw, want_tgt, want_lpt, kind, src = sweep._parse_want(want)
    red = None
    if kind is not None:
        red = sweep._reduce_plain(kind, logw if src == "logw" else lpt,
                                  tgt.long() if kind == "pmf" else tgt,
                                  k_pmf if kind == "pmf" else 3)
    return (logw if want_logw else None, tgt if want_tgt else None,
            lpt if want_lpt else None, red)


def asia_static_scan(asia_vbn, b):
    """(plan, cpds, params, packed [b, N], tgt [b]) of asia's static plan
    P(dysp | smoke, asia, do xray) as the scan kernel takes it."""
    import torch

    from vectorizedbayesiannetwork_torch.core.plan import get_plan

    plan = get_plan(asia_vbn, asia_vbn._normalize_query(asia_query(b)))
    cpds = tuple(asia_vbn.cpd_spec(n) for n in plan.topo_order)
    params = tuple(asia_vbn.params[n] for n in plan.topo_order)
    fixed_i = kernel_inputs(asia_vbn, asia_query(b), False)[0]
    dev = fixed_i.device
    bits = (torch.tensor(plan.evidence_mask, device=dev).int() << 16) | (
        torch.tensor(plan.do_mask, device=dev).int() << 17)
    tgt = torch.full((b,), plan.target_idx, dtype=torch.int32, device=dev)
    return plan, cpds, params, (fixed_i | bits).contiguous(), tgt


def check_scan_kernels(asia_vbn, link_vbn, link_qs, high_bn, high_vbn,
                       gauss_vbn, gauss_qs):
    """vbn_cat_scan bitwise against its plain version (streams exact,
    reductions within their tolerance) at B_CHECK x S_CHECK in every
    ``want`` mode, on external uniforms and on its grouped Philox stream,
    on link724, highcard and asia's static plan; vbn_lg_scan within its
    tolerances; and vbn_cat_scan against vbn_cat_sweep bit for bit on
    asia's static plan, both fed the same external uniforms, and each on
    its own in-kernel stream."""
    import torch

    from vectorizedbayesiannetwork_torch.core.rng import philox_uniforms
    from vectorizedbayesiannetwork_torch.ops import sweep, sweep_scan

    errs = {"categorical_scan": 0.0, "lg_scan": 0.0}
    dev = link_vbn.device
    gen = torch.Generator(device=dev).manual_seed(4321)
    cases = [("link724", link_vbn,
              [as_query(t, ev) for t, ev in link_qs[:B_CHECK]]),
             ("highcard", high_vbn, hetero_queries(high_bn, B_CHECK, 5)),
             ("asia_static", asia_vbn, None)]
    for tag, vbn, qs in cases:
        if qs is None:
            plan, cpds, params, packed, tgt = asia_static_scan(vbn, B_CHECK)
        else:
            plan, cpds, params, fixed, ev, do, tgt = scan_inputs(vbn, qs)
        struct = sweep_scan.scan_struct_for(plan, cpds)
        if qs is not None:
            packed = sweep_scan.pack_rows(fixed, ev, do, struct[2])
        flat = sweep_scan._flat_counts(cpds, params)
        u = torch.rand((B_CHECK, plan.n_nodes, S_CHECK), generator=gen,
                       device=dev).clamp(1e-6, 1 - 1e-6)
        for u_ext in (u, None):
            mode = "u_ext" if u_ext is not None else "philox_grouped"
            ref = sweep_scan.categorical_sweep_scan_plain(
                21, packed, tgt, flat, struct, S_CHECK, u_ext=u_ext,
                want=("logw", "tgt", "lpt"))
            for want in CAT_WANTS:
                k_out = sweep_scan.categorical_sweep_scan(
                    21, packed, tgt, flat, struct, S_CHECK, u_ext=u_ext,
                    want=want)
                torch.cuda.synchronize()
                errs["categorical_scan"] = max(errs["categorical_scan"], check_outputs(
                    f"vbn_cat_scan {tag} {want} {mode}", k_out,
                    plain_for(want, ref, struct[7]), want, tgt_atol=0,
                    lp_atol=0))
            log("scan_kernel_check", kernel="vbn_cat_scan", network=tag,
                n_nodes=plan.n_nodes, cmax=struct[7], uniforms=mode,
                wants=[list(w) for w in CAT_WANTS], streams="bitwise", ok=True)
        del u

    plan, cpds, params, fixed, ev, do, tgt = scan_inputs(
        gauss_vbn, [as_query(t, e) for t, e in gauss_qs[:B_CHECK]])
    struct = sweep_scan.lg_scan_struct_for(plan, cpds)
    fixed, flags = sweep_scan.lg_rows(fixed, ev, do)
    ptab = sweep_scan.lg_ptab_flat(cpds, params, struct[2])
    u = torch.rand((B_CHECK, 2 * plan.n_nodes, S_CHECK), generator=gen,
                   device=dev).clamp(1e-6, 1 - 1e-6)
    for u_ext in (u, None):
        mode = "u_ext" if u_ext is not None else "philox_grouped"
        ref = sweep_scan.lg_sweep_scan_plain(
            22, fixed, flags, tgt, ptab, struct, S_CHECK, u_ext=u_ext,
            want=("logw", "tgt", "lpt"))
        for want in LG_WANTS:
            k_out = sweep_scan.lg_sweep_scan(
                22, fixed, flags, tgt, ptab, struct, S_CHECK, u_ext=u_ext,
                want=want)
            torch.cuda.synchronize()
            errs["lg_scan"] = max(errs["lg_scan"], check_outputs(
                f"vbn_lg_scan {want} {mode}", k_out, plain_for(want, ref, 3),
                want, tgt_atol=2e-4, lp_atol=2e-3))
        log("scan_kernel_check", kernel="vbn_lg_scan", network="gauss107",
            n_nodes=plan.n_nodes, uniforms=mode,
            wants=[list(w) for w in LG_WANTS], ok=True)

    # on the same external uniforms (the grouped Philox stream) the scan
    # kernel draws the unrolled kernel's classes on a static plan, and the
    # two draw the same stream in-kernel
    plan, cpds, params, packed, tgt = asia_static_scan(asia_vbn, B_CHECK)
    fixed_i, counts, st, _ = kernel_inputs(asia_vbn, asia_query(B_CHECK), False)
    want = ("logw", "tgt", "lpt")
    u = philox_uniforms(31, B_CHECK, plan.n_nodes, S_CHECK, 1, dev, grouped=True)
    args = (packed, tgt, sweep_scan._flat_counts(cpds, params),
            sweep_scan.scan_struct_for(plan, cpds), S_CHECK)
    a = sweep.categorical_sweep_fused(31, fixed_i, counts, st, S_CHECK,
                                      u_ext=u, want=want)
    b = sweep_scan.categorical_sweep_scan(31, *args, u_ext=u, want=want)
    c = sweep_scan.categorical_sweep_scan(31, *args, want=want)
    d = sweep.categorical_sweep_fused(31, fixed_i, counts, st, S_CHECK,
                                      want=want)
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(x, y)) for k, x, y in zip(want, a[:3], b[:3])}
    same_stream = {k: bool(torch.equal(x, y)) for k, x, y in zip(want, b[:3], c[:3])}
    same_in_kernel = {k: bool(torch.equal(x, y))
                      for k, x, y in zip(want, c[:3], d[:3])}
    log("scan_matches_unrolled", network="asia", seed=31,
        uniforms="philox_uniforms(grouped=True) as u_ext", equal=same,
        in_kernel_stream_equal=same_stream,
        in_kernel_streams_of_both_equal=same_in_kernel)
    if not all(same.values()) or not all(same_stream.values()) \
            or not all(same_in_kernel.values()):
        raise AssertionError(f"vbn_cat_scan != vbn_cat_sweep bitwise: {same}, "
                             f"in-kernel stream: {same_stream}, both in-kernel: "
                             f"{same_in_kernel}")
    return errs


def serve_dynamic_main_path(link_bn, link_vbn, link_qs, gauss_vbn, gauss_qs):
    """Both workloads through the public entry points, each with the
    counters reset just before and read just after."""
    import torch

    qs = [as_query(t, ev) for t, ev in link_qs]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    pmf, spans = link_vbn.infer_posterior_pmf(qs, n_classes=4, pad_bucket=N_DYN)
    link_launches = read_launches({"categorical_scan": 1})
    link_mem = torch.cuda.max_memory_allocated()
    gq = [as_query(t, ev) for t, ev in gauss_qs]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mom, gspans = gauss_vbn.infer_posterior_moments(gq, pad_bucket=N_DYN)
    lg_launches = read_launches({"lg_scan": 1})
    lg_mem = torch.cuda.max_memory_allocated()
    paths = (link_vbn._last_summary_path, gauss_vbn._last_summary_path)
    log("dynamic_main_path", launches_link=link_launches,
        launches_lg=lg_launches, path_link=paths[0], path_lg=paths[1],
        max_memory_allocated_bytes_link=link_mem,
        max_memory_allocated_bytes_lg=lg_mem)
    if paths != ("fused", "fused"):
        raise AssertionError(f"summary paths {paths} != fused")
    if pmf.shape != (N_DYN, 4) or not np.isfinite(pmf).all():
        raise AssertionError(f"link pmf rows bad: {pmf.shape}")
    if mom.shape != (N_DYN, 2) or not np.isfinite(mom).all():
        raise AssertionError(f"LG moments rows bad: {mom.shape}")
    link = link_accuracy(link_bn, link_vbn, link_qs, pmf, spans)
    lg = gauss_accuracy(gauss_vbn, gauss_qs, mom, gspans)
    log("dynamic_main_path_accuracy", link=link, lg=lg)
    if link["kl_median"] > 2e-3:
        raise AssertionError(f"link median KL {link['kl_median']} > 2e-3")
    if lg["dmean_over_std"] > 0.05 or lg["dstd_over_std"] > 0.05:
        raise AssertionError(f"LG moments off the closed form: {lg}")
    return {"categorical_scan": link_launches["categorical_scan"],
            "lg_scan": lg_launches["lg_scan"]}


def serve_dynamic_streams(link_bn, link_vbn, link_qs):
    """infer_posterior_many (LW, MCM) on 8 link-scale queries, one launch
    each, and one static 724-node LW query, at S_STREAMS."""
    from benchmarking.exact import exact_posterior

    fit = fitted_discrete_bn(link_bn, link_vbn, floor=1e-12)
    qs = [as_query(t, ev) for t, ev in link_qs[:B_CHECK]]
    report = {}
    for method in ("likelihood_weighting", "monte_carlo_marginalization"):
        link_vbn.set_inference_method(method, n_samples=S_STREAMS,
                                      dynamic_masks=True)
        reset_launches()
        res = link_vbn.infer_posterior_many(qs)
        read_launches({"categorical_scan": 1})
        for pdf, samples in res:
            if pdf.shape != (1, S_STREAMS) or samples.shape != (1, S_STREAMS, 1):
                raise AssertionError(f"{method} streams bad: {pdf.shape}")
            if not bool(pdf.isfinite().all()):
                raise AssertionError(f"{method} weights not finite")
        report[method] = len(res)
    link_vbn.set_inference_method("likelihood_weighting", n_samples=S_STREAMS)
    reset_launches()
    t, ev = link_qs[0]
    w, samples = link_vbn.infer_posterior(as_query(t, ev))
    read_launches({"categorical_scan": 1})
    gt = np.asarray(exact_posterior(fit, t, ev))
    x = samples[0, :, 0].long().cpu().numpy()
    p = np.bincount(x, weights=w[0].double().cpu().numpy(), minlength=len(gt))
    err = float(np.abs(p / p.sum() - gt).max())
    log("dynamic_streams", many_rows=report, static_query_max_abs_err=err,
        static_route="scan")
    if err > 0.05:
        raise AssertionError(f"static 724-node LW query off exact by {err}")
    link_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN,
                                  dynamic_masks=True)


def cat_scan_cost(struct, packed, s, want, k, threads):
    """(operations, bytes) of one categorical scan call, counted as
    ``cat_cost`` counts them but per row from the row's own masks: per
    node the parent row (2 per parent) and the class total (c-1); per
    latent node a quarter Philox call and the uniform (28: one 32-bit word),
    the threshold (1) and the walk (3(c-1)); 5 per weighted node; per
    particle the reduction (3 + 2 for one histogram add, 3 + 5 for
    moments). Bytes: each input read once (packed rows, targets, count
    table, plan metadata), each partial written once."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    cards = np.asarray(struct[2])
    npar = np.asarray([sum(1 for st in row if st) for row in struct[4]])
    pk = packed.cpu().numpy()
    fx, ev = ((pk >> 16) & 3) > 0, ((pk >> 16) & 1) > 0
    per_row = (2 * npar + cards - 1).sum() + np.where(
        fx, 0, 29 + 3 * (cards - 1)).sum(axis=1)
    red = next(w for w in want if "_" in w)
    per_row = per_row + (5 * ev.sum(axis=1) if red.endswith("logw") else 5)
    per_row = per_row + 3 + (2 if red.startswith("pmf") else 5)
    nblk = s // (threads * sweep_scan._ppt(s, threads))
    b = pk.shape[0]
    rec, par = sweep_scan._cat_meta_host(struct)[:2]
    nbytes = 4 * (pk.size + b + struct[5] + rec.size + par.size
                  + b * nblk * (k + 1))
    return int(per_row.sum()) * s, nbytes


def lg_scan_cost(n_par, struct, flags, s, want, threads):
    """(operations, bytes) of one LG scan call, counted as ``lg_cost``
    per row: 2 per parent for the location; per latent node two 32-bit
    random words (56: a quarter Philox call and the uniform each),
    Box-Muller (6) and the draw (2); 8 per weighted node; 8 per particle
    for the moments."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    pids, pmax, dmax = struct
    n = len(pids)
    fl = flags.cpu().numpy()
    b = fl.shape[0]
    red = next(w for w in want if "_" in w)
    per_row = 2 * n_par + np.where(fl > 0, 0, 64).sum(axis=1)
    per_row = per_row + (8 * (fl & 1).sum(axis=1) if red.endswith("logw") else 8)
    per_row = per_row + 8
    nblk = s // (threads * sweep_scan._ppt(s, threads))
    nbytes = 4 * (2 * fl.size + b + n * (dmax + 2) + n * (1 + pmax)
                  + b * nblk * 4)
    return int(per_row.sum()) * s, nbytes


def time_plain_batch(plain, b):
    """(ms, reduction) of ``plain(r0, r1)`` over all ``b`` rows of a batch,
    SCAN_PLAIN_ROWS rows a call (each call draws its rows' own Philox
    stream through ``row0``), timed once over the batch with CUDA events;
    the reduction's two parts concatenated over the rows."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    parts = [plain(r, min(r + SCAN_PLAIN_ROWS, b))[3]
             for r in range(0, b, SCAN_PLAIN_ROWS)]
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), (torch.cat([p[0] for p in parts]),
                                 torch.cat([p[1] for p in parts]))


def time_scan_kernels(link_vbn, link_qs, gauss_vbn, gauss_qs, launches, errs):
    """Each scan kernel at the main path's shape and ``want`` mode, in
    in-kernel Philox mode; its plain version over the same batch
    (``time_plain_batch``), and the two reductions held against each
    other over every row."""
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    plan, cpds, params, fixed, ev, do, tgt = scan_inputs(
        link_vbn, [as_query(t, e) for t, e in link_qs])
    struct = sweep_scan.scan_struct_for(plan, cpds)
    packed = sweep_scan.pack_rows(fixed, ev, do, struct[2])
    flat = sweep_scan._flat_counts(cpds, params)
    want = ("pmf_logw",)
    kernel = lambda: sweep_scan.categorical_sweep_scan(  # noqa: E731
        5, packed, tgt, flat, struct, S_MAIN, want=want)
    ms = cuda_ms(kernel, SCAN_REPS)
    got = kernel()[3]
    plain_ms, ref = time_plain_batch(
        lambda a, b: sweep_scan.categorical_sweep_scan_plain(
            5, packed[a:b], tgt[a:b], flat, struct, S_MAIN, want=want, row0=a),
        packed.shape[0])
    err = compare_red(f"vbn_cat_scan at S={S_MAIN}", got, ref, "pmf",
                      rtol=2e-4, shift_atol=1e-4)
    rec, par, n_slots, tab_len = sweep_scan._cat_meta_host(struct)[:4]
    resident = 4 * (tab_len + rec.size + par.size)
    bits = sweep_scan._scratch_bits(struct[7])
    layout = {b: sweep_scan.cat_scan_layout(plan.n_nodes, n_slots, struct[7], b,
                                            resident, 1, 0) for b in (bits, 8)}
    threads, carve_kb, blocks = layout[bits]
    log("kernel_main_shape", kernel="vbn_cat_scan", batch=N_DYN, ms=ms,
        plain_ms=plain_ms, served_row_max_abs_err=err, threads=threads,
        scratch_bits=bits, carveout_kb=carve_kb, blocks_per_sm=blocks,
        resident_table_and_meta_bytes=resident,
        shared_bytes_per_block=sweep_scan._cat_scan_smem(
            plan.n_nodes, n_slots, threads, struct[7], bits),
        byte_scratch_layout={"threads": layout[8][0], "carveout_kb": layout[8][1],
                             "blocks_per_sm": layout[8][2]})
    cat = kernel_row(
        "vbn_cat_scan", "vectorizedbayesiannetwork_tpu/ops/sweep_scan_pallas.py:210",
        launches["categorical_scan"], max(errs["categorical_scan"], err), ms,
        plain_ms,
        cat_scan_cost(struct, packed, S_MAIN, want, struct[7], threads),
        source="vectorizedbayesiannetwork_torch/csrc/sweep_scan.cu")

    plan, cpds, params, fixed, ev, do, tgt = scan_inputs(
        gauss_vbn, [as_query(t, e) for t, e in gauss_qs])
    struct = sweep_scan.lg_scan_struct_for(plan, cpds)
    fixed, flags = sweep_scan.lg_rows(fixed, ev, do)
    ptab = sweep_scan.lg_ptab_flat(cpds, params, struct[2])
    want = ("mom_logw",)
    kernel = lambda: sweep_scan.lg_sweep_scan(  # noqa: E731
        6, fixed, flags, tgt, ptab, struct, S_MAIN, want=want)
    ms = cuda_ms(kernel, SCAN_REPS)
    got = kernel()[3]
    plain_ms, ref = time_plain_batch(
        lambda a, b: sweep_scan.lg_sweep_scan_plain(
            6, fixed[a:b], flags[a:b], tgt[a:b], ptab, struct, S_MAIN,
            want=want, row0=a),
        fixed.shape[0])
    err = compare_red(f"vbn_lg_scan at S={S_MAIN}", got, ref, "mom",
                      rtol=2e-3, shift_atol=2e-3)
    n_slots = sweep_scan.lg_slot_map(struct[0])[2]
    resident = sweep_scan.lg_resident_bytes(struct)
    threads, carve_kb, blocks = sweep_scan.lg_scan_layout(
        plan.n_nodes, n_slots, 2, resident, 0)
    log("kernel_main_shape", kernel="vbn_lg_scan", batch=N_DYN, ms=ms,
        plain_ms=plain_ms, served_row_max_abs_err=err, threads=threads,
        carveout_kb=carve_kb, blocks_per_sm=blocks,
        resident_records_bytes=resident, value_slots=n_slots,
        shared_bytes_per_block=sweep_scan._lg_scan_smem(
            plan.n_nodes, n_slots, threads, True))
    lg = kernel_row(
        "vbn_lg_scan", "vectorizedbayesiannetwork_tpu/ops/sweep_scan_pallas.py:978",
        launches["lg_scan"], max(errs["lg_scan"], err), ms,
        plain_ms,
        lg_scan_cost(sum(len(p) for p in plan.parent_idx), struct, flags,
                     S_MAIN, want, threads),
        source="vectorizedbayesiannetwork_torch/csrc/sweep_scan.cu")
    return [cat, lg]


def profile_batch(serve, kernels=("scan_kernel",), top=0):
    """One served batch under torch.profiler: its wall ms (host clock, to
    the rows' fetch), the device's busy ms (kernels and copies), the ms of
    the device events whose names hold each of ``kernels``, the device's
    idle share of the wall time, and with ``top`` the device ms of the
    ``top`` longest event names (summed over their events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"wall_ms": wall, "device": "not measured (no CUDA events)"}
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    named = {f"{k}_ms": sum(e.time_range.elapsed_us() for e in dev
                            if k in e.name) / 1e3 for k in kernels}
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    longest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    if longest:
        named["top_device_ms"] = [[k[:72], v / 1e3] for k, v in longest]
    return {"wall_ms": wall, "device_busy_ms": busy, **named,
            "device_events": len(dev), "idle_share": 1.0 - busy / wall}


def device_ms(fn, reps, kernels, split=False):
    """Device ms a call of ``fn`` launches under ``kernels`` (one launch of
    each a call): over ``reps`` calls after a warm-up, the mean duration of
    the torch.profiler device events whose names hold each name, summed
    over the names. For kernels shorter than their wrapper's host path,
    where CUDA events around the wrapper time the host's enqueue. The
    profiler can drop device events late in a long process, so a
    mean over the events it kept; a window with none of some name is taken
    again (at most three), then it fails. ``split``: a dict of each name's
    ms in place of their sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        us = {k: [e.time_range.elapsed_us() for e in dev if k in e.name]
              for k in kernels}
        if all(us.values()):
            ms = {k: float(np.mean(v)) / 1e3 for k, v in us.items()}
            return ms if split else sum(ms.values())
        log("device_ms_retry", kernels=kernels, device_events=len(dev),
            matched={k: len(v) for k, v in us.items()})
    raise AssertionError(f"device_ms: no device events of {kernels}")


def dynamic_qps(serve, b=N_DYN):
    """queries/s of one served batch of ``b`` queries, best of
    SCAN_WINDOWS (each window one batch, ending in the rows' fetch)."""
    serve()
    qps = []
    for _ in range(SCAN_WINDOWS):
        t0 = time.perf_counter()
        serve()
        qps.append(b / (time.perf_counter() - t0))
    return max(qps), qps


def serve_large_networks(vbn_cls, defaults, asia_vbn):
    """Phases 6-9 (the mask-dynamic slice); returns the scan kernels'
    rows of the kernel line, and the (network, model, queries) of the
    link-scale and gauss107 cells."""
    from benchmarking.gaussian_bn import random_gaussian
    from benchmarking.networks import random_bn, random_bn_treewidth

    t0 = time.perf_counter()
    link_bn = random_bn_treewidth(724, seed=0)
    link_vbn = fit_discrete(vbn_cls, defaults, link_bn)
    link_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN,
                                  dynamic_masks=True)
    high_bn = random_bn(n_nodes=6, max_card=80, max_indegree=1, seed=0)
    high_vbn = fit_discrete(vbn_cls, defaults, high_bn, seed=3)
    high_vbn.set_inference_method("likelihood_weighting", n_samples=S_CHECK,
                                  dynamic_masks=True)
    gbn = random_gaussian(107, seed=0)
    gauss_vbn = fit_gaussian(vbn_cls, defaults, gbn)
    gauss_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN,
                                   dynamic_masks=True)
    link_qs, gauss_qs = link_queries(link_bn), gauss_queries(gbn)
    log("fit_large", seconds=time.perf_counter() - t0,
        link_nodes=len(link_bn.nodes), gauss_nodes=len(gbn.nodes))

    t0 = time.perf_counter()
    errs = check_scan_kernels(asia_vbn, link_vbn, link_qs, high_bn, high_vbn,
                              gauss_vbn, gauss_qs)
    log("scan_kernel_check_done", max_abs_err=errs,
        seconds=time.perf_counter() - t0)
    launches = serve_dynamic_main_path(link_bn, link_vbn, link_qs, gauss_vbn,
                                       gauss_qs)
    serve_dynamic_streams(link_bn, link_vbn, link_qs)
    kernels = time_scan_kernels(link_vbn, link_qs, gauss_vbn, gauss_qs,
                                launches, errs)
    lq = [as_query(t, ev) for t, ev in link_qs]
    gq = [as_query(t, ev) for t, ev in gauss_qs]
    link_qps, link_w = dynamic_qps(lambda: link_vbn.infer_posterior_pmf(
        lq, n_classes=4, pad_bucket=N_DYN))
    lg_qps, lg_w = dynamic_qps(lambda: gauss_vbn.infer_posterior_moments(
        gq, pad_bucket=N_DYN))
    log("end_to_end_dynamic", link724_lw_pmf_qps=link_qps,
        link724_window_qps=link_w, gauss107_lw_moments_qps=lg_qps,
        gauss107_window_qps=lg_w)
    for tag, qps, row in (("link724", link_qps, kernels[0]),
                          ("gauss107", lg_qps, kernels[1])):
        batch_ms = 1e3 * N_DYN / qps
        log("serve_breakdown", workload=tag, batch_ms=batch_ms,
            kernel_ms=row["ms"], kernel_share=row["ms"] / batch_ms)
    log("serve_profile", workload="link724", **profile_batch(
        lambda: link_vbn.infer_posterior_pmf(lq, n_classes=4, pad_bucket=N_DYN)))
    log("serve_profile", workload="gauss107", **profile_batch(
        lambda: gauss_vbn.infer_posterior_moments(gq, pad_bucket=N_DYN)))
    return kernels, (link_bn, link_vbn, link_qs), (gbn, gauss_vbn, gauss_qs)


# ---------------------------------------------------------------------------
# The resampling slice: RIS and IS on the resampling kernels
# ---------------------------------------------------------------------------


def quantized_profile(name: str, b: int, s: int) -> np.ndarray:
    """[b, s] weights of one profile of tests/test_resample_pallas.py:24-53
    (heavy-tailed Dirichlet, uniform, all mass last, all mass first,
    alternate dead 256-blocks, mixed delta/uniform/random rows), rounded to
    integer multiples of 2^-23 that sum to exactly 1 per row: every
    grouping of their sums is then exact, so kernel and plain version agree
    bit for bit. The resampling tests import it from here."""
    rng = np.random.default_rng(PROFILES.index(name))
    if name == "dirichlet":
        w = rng.dirichlet(np.full(s, 0.3), size=b)
    elif name == "uniform":
        w = np.full((b, s), 1.0 / s)
    elif name in ("last", "first"):
        w = np.zeros((b, s))
        w[:, -1 if name == "last" else 0] = 1.0
    elif name == "alternate":
        w = np.tile((np.arange(s) // 256 % 2).astype(float), (b, 1))
    else:
        delta = np.zeros(s)
        delta[s // 2] = 1.0
        rows = [delta, np.full(s, 1.0 / s), rng.dirichlet(np.ones(s))]
        w = np.stack([rows[r % 3] for r in range(b)])
    w = w / w.sum(axis=1, keepdims=True)
    k = np.round(w * 2.0**23).astype(np.int64)
    k[np.arange(b), k.argmax(axis=1)] += (1 << 23) - k.sum(axis=1)
    return (k / 2.0**23).astype(np.float32)


def exact(tag, got, want):
    import torch

    if isinstance(got, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            exact(f"{tag}[{i}]", g, w)
        return 0.0
    if got.shape != want.shape or not bool(torch.equal(got, want)):
        bad = (got != want).sum() if got.shape == want.shape else "shape"
        raise AssertionError(f"{tag}: kernel != plain version ({bad} entries)")
    return 0.0


def check_resample_kernels(dev):
    """Each resampling kernel against its plain version on the same inputs;
    returns the max abs error per kernel (0 where the check is exact)."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm
    from vectorizedbayesiannetwork_torch.ops import scan

    b = B_CHECK
    g = torch.Generator(device=dev).manual_seed(2024)
    errs = {"cumsum": 0.0, "cum_index": 0.0, "srg": 0.0, "spg": 0.0}
    for s, name in ((s, n) for s in (S_CHECK, S_RIS) for n in PROFILES):
        w = torch.as_tensor(quantized_profile(name, b, s), device=dev)
        for mono in (False, True):
            exact(f"vbn_cumsum {name} S={s} monotone={mono}",
                  scan.cumsum_rows(w, mono), scan.cumsum_rows_plain(w, mono))
        cum = rm.norm_cum(w)
        u0 = torch.rand((b, 1), generator=g, device=dev)
        pos = torch.sort(torch.rand((b, 2 * s), generator=g, device=dev)).values
        pos[:, 0], pos[:, -1] = 0.0, 1.0
        # tile heads, and out of order; ties with the window lasts; the
        # ends of [0, 1 - 2^-24]
        lasts = cum[:, rm.W - 1 :: rm.W]
        ends = torch.tensor([0.0, rm.POS_MAX], device=dev).expand(b, 2)
        sys_q = rm.systematic_positions(u0, s, rm.T)
        for q in (sys_q, sys_q.flip(1), pos[:, :: rm.T],
                  torch.cat([lasts, ends], 1)):
            exact(f"vbn_cum_index {name} S={s}", rm.cum_index(cum, q),
                  rm.cum_index_plain(cum, q))
        for d in (1, 3, 5):
            vals = torch.randn((b, s, d), generator=g, device=dev)
            exact(f"vbn_srg {name} S={s} D={d}", rm.srg(u0, cum, vals),
                  rm.srg_plain(u0, cum, vals))
            for s_out in (s, s // 2, 2 * s):
                p = pos[:, :: 2 * s // s_out]  # spanning [0, 1)
                exact(f"vbn_spg {name} S={s} D={d} S_out={s_out}",
                      rm.sorted_gather(cum, p, vals), rm.spg_plain(cum, p, vals))
        log("resample_kernel_check", profile=name, B=b, S=s, D=[1, 3, 5],
            spg_S_out=[s, s // 2, 2 * s], ok=True)
    s = S_CHECK  # the checks below are exact at S = 2^16
    # high u0: (S-1+u0)/S rounds to 1.0; the clamp keeps a real particle
    w = torch.full((2, s), 1.0 / s, device=dev)
    vals = torch.arange(1, s + 1, dtype=torch.float32, device=dev)
    vals = vals[None, :, None].repeat(2, 1, 1)
    u0 = torch.tensor([[0.5], [1.0 - 2.0**-24]], device=dev)
    got = rm.systematic_resample_gather(w, vals, u0=u0)
    exact("vbn_srg high u0", got, rm.systematic_resample_gather_plain(w, vals, u0=u0))
    if float(got.min()) < 1.0 or float(got[1, -1, 0]) != s:
        raise AssertionError("high u0: the last position left the particles")
    # multinomial order statistics: Exp draws in multiples of 2^-6 below 8,
    # whose partial sums stay exact (under 2^24 quanta) at S = 2^16
    w = torch.as_tensor(quantized_profile("dirichlet", b, s), device=dev)
    vals = torch.randn((b, s, 1), generator=g, device=dev)
    e = torch.empty((b, s + 1), device=dev).exponential_(generator=g)
    e = torch.round(torch.clamp(e, max=7.9) * 64.0) / 64.0
    c = scan.cumsum_rows_plain(e, monotone=True)
    exact("multinomial", rm.multinomial_resample_gather(w, vals, e=e),
          rm.spg_plain(rm.norm_cum(w), c[:, :s] / c[:, -1:], vals))
    # S = 2^22: unquantized weights, norm_cum's monotone cumsum; the merges
    # are held against their plain versions on the kernel's CDF
    big = S_RIS_BIG
    w = torch.rand((B_RIS, big), generator=g, device=dev) ** 8
    w = w / w.sum(dim=1, keepdim=True)  # RIS passes softmax weights
    k_cum = scan.cumsum_rows(w, True)
    p_cum = scan.cumsum_rows_plain(w, True)
    ref = torch.cumsum(w.double(), dim=1)  # float64 prefix sums
    rel = {tag: float(((c.double() - ref).abs() / ref[:, -1:]).max())
           for tag, c in (("kernel", k_cum), ("plain", p_cum))}
    # float32 prefix sums of 2^22 terms drift by ~1e-4 of the total at
    # worst (the JAX note, resample_pallas.py:124-127)
    if rel["kernel"] > 1e-4 or not bool((k_cum.diff(dim=1) >= 0).all()):
        raise AssertionError(f"vbn_cumsum at S=2^22: {rel} of the row total, "
                             "or not monotone")
    errs["cumsum"] = float((k_cum - p_cum).abs().max())
    cum = rm.norm_cum(w)
    u0 = torch.rand((B_RIS, 1), generator=g, device=dev)
    q = rm.systematic_positions(u0, big, rm.T)
    exact("vbn_cum_index S=2^22", rm.cum_index(cum, q),
          rm.cum_index_plain(cum, q))
    pos = torch.sort(torch.rand((B_RIS, big), generator=g, device=dev)).values
    for d in (1, 3, 5):
        vals = torch.randn((B_RIS, big, d), generator=g, device=dev)
        exact(f"vbn_srg S=2^22 D={d}", rm.srg(u0, cum, vals),
              rm.srg_plain(u0, cum, vals))
        exact(f"vbn_spg S=2^22 D={d}", rm.sorted_gather(cum, pos, vals),
              rm.spg_plain(cum, pos, vals))
    log("resample_kernel_check", case="S=2^22 monotone", B=B_RIS, S=big,
        cumsum_err_over_total_vs_float64=rel,
        cumsum_kernel_vs_plain_max_abs=errs["cumsum"], ok=True)
    return errs


def flagship_diag_query(b=B_RIS):
    """The RIS/IS workload of benchmarking/tpu_study.py:39-46: x0 given
    x2 = linspace(-1, 1, b)."""
    return {"target": "x0", "evidence": {
        "x2": np.linspace(-1, 1, b).reshape(b, 1).astype(np.float32)}}


def diag_accuracy(lg_vbn, q, w, samples):
    """Worst |d mean| / std and |d std| / std of the served (mean, std) of
    x0 against the fitted network's closed form."""
    st = lg_vbn._posterior_stats(w, samples)
    mean = st["mean"][:, 0].double().cpu().numpy()
    std = st["std"][:, 0].double().cpu().numpy()
    fit = fitted_gaussian_bn(lg_vbn)
    cf = np.array([fit.conditional("x0", {"x2": float(v)})
                   for v in q["evidence"]["x2"][:, 0]])
    return {"dmean_over_std": float(np.max(np.abs(mean - cf[:, 0]) / cf[:, 1])),
            "dstd_over_std": float(np.max(np.abs(std - cf[:, 1]) / cf[:, 1]))}


def serve_ris(lg_vbn):
    """RIS on the flagship diagnosis query, three runs through the public
    entry point; returns the launches of all three."""
    import torch

    q = flagship_diag_query()
    total = {}
    for method, s in (("systematic", S_RIS), ("multinomial", S_RIS),
                      ("systematic", S_RIS_BIG)):
        lg_vbn.set_inference_method("resampled_importance_sampling",
                                    n_samples=s, ess_threshold=0.5,
                                    resample_method=method)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        w, samples = lg_vbn.infer_posterior(q)
        torch.cuda.synchronize()
        merge = "srg" if method == "systematic" else "spg"
        launches = read_launches({"cumsum": 1 if merge == "srg" else 2,
                                  merge: 1, "uniforms": SOME})
        mem = torch.cuda.max_memory_allocated()
        resampled = lg_vbn._inference._last_resampled
        acc = diag_accuracy(lg_vbn, q, w, samples)
        log("ris_main_path", method=method, S=s, B=B_RIS, launches=launches,
            resampled=resampled, ess=lg_vbn._inference._last_ess.tolist(),
            max_memory_allocated_bytes=mem, **acc)
        if not resampled:
            raise AssertionError("RIS did not resample the flagship query")
        if acc["dmean_over_std"] > 0.05 or acc["dstd_over_std"] > 0.05:
            raise AssertionError(f"RIS moments off the closed form: {acc}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def serve_ris_asia(bn, asia_vbn):
    """asia P(lung | xray, dysp), the four evidence patterns twice, RIS at
    ess_threshold 0.99: two resampling events (3 live columns, then 1)."""
    from benchmarking.exact import exact_posterior

    xr = np.array([0, 0, 1, 1, 0, 0, 1, 1], np.float32)
    dy = np.array([0, 1, 0, 1, 0, 1, 0, 1], np.float32)
    q = {"target": "lung",
         "evidence": {"xray": xr.reshape(-1, 1), "dysp": dy.reshape(-1, 1)}}
    asia_vbn.set_inference_method("resampled_importance_sampling",
                                  n_samples=S_RIS, ess_threshold=0.99)
    reset_launches()
    w, samples = asia_vbn.infer_posterior(q)
    launches = read_launches({"cumsum": 2, "srg": 2, "uniforms": SOME})
    fit = fitted_discrete_bn(bn, asia_vbn)
    err = 0.0
    x = samples[:, :, 0].long()
    for r in range(B_RIS):
        pmf = np.array([float(w[r][x[r] == c].double().sum()) for c in (0, 1)])
        gt = np.asarray(exact_posterior(fit, "lung", {"xray": int(xr[r]),
                                                      "dysp": int(dy[r])}))
        err = max(err, float(np.abs(pmf / pmf.sum() - gt).max()))
    log("ris_asia", launches=launches, resampled=asia_vbn._inference._last_resampled,
        pmf_max_abs_err=err)
    asia_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    if err > 5e-3:
        raise AssertionError(f"asia RIS pmf off the exact posterior by {err}")


def serve_is(lg_vbn, link):
    """IS: the flagship diagnosis query (static, S=2^20), and the 96
    link-scale queries with dynamic_masks=True at S=2^16."""
    link_bn, link_vbn, link_qs = link
    q = flagship_diag_query()
    lg_vbn.set_inference_method("importance_sampling", n_samples=S_RIS)
    w, samples = lg_vbn.infer_posterior(q)
    acc = diag_accuracy(lg_vbn, q, w, samples)
    log("is_main_path", workload="flagship diagnosis", B=B_RIS, S=S_RIS,
        fallback=lg_vbn._inference._last_fallback,
        ess=lg_vbn._inference._last_ess.tolist(), **acc)
    if acc["dmean_over_std"] > 0.05 or acc["dstd_over_std"] > 0.05:
        raise AssertionError(f"IS moments off the closed form: {acc}")
    qs = [as_query(t, ev) for t, ev in link_qs]
    link_vbn.set_inference_method("importance_sampling", n_samples=S_IS_DYN,
                                  dynamic_masks=True)
    reset_launches()
    pmf, spans = link_vbn.infer_posterior_pmf(qs, n_classes=4, pad_bucket=N_DYN)
    launches = read_launches({"categorical_scan": 2})
    acc = link_accuracy(link_bn, link_vbn, link_qs, pmf, spans)
    log("is_main_path", workload="link724 dynamic", S=S_IS_DYN,
        queries=len(qs), launches=launches,
        fallback=link_vbn._inference._last_fallback, **acc)
    if acc["kl_median"] > 2e-3:
        raise AssertionError(f"IS link median KL {acc['kl_median']} > 2e-3")


CUMSUM_KERNELS = ("cumsum_tile_kernel", "cumsum_kernel")  # a call's two passes


def time_resample_kernels(dev, launches, errs):
    """Each resampling kernel at B=8, S=2^20 (the RIS main path's shape):
    held exactly against its plain version there (``vbn_srg`` at D=1 and
    D=3, as the flagship and asia's first event give it), then its device
    ms (``device_ms``: these kernels are shorter than their wrappers' host
    path) beside the wrapper's CUDA-event ms (``wrapper_ms``), its plain
    version's and one PyTorch call's ms (CUDA events), and the byte bound."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm
    from vectorizedbayesiannetwork_torch.ops import scan

    b, s = B_RIS, S_RIS
    g = torch.Generator(device=dev).manual_seed(7)
    src = "vectorizedbayesiannetwork_torch/csrc/resample.cu"
    tpu = "vectorizedbayesiannetwork_tpu/ops/"
    w = torch.as_tensor(quantized_profile("dirichlet", b, s), device=dev)
    # multinomial's Exp draws [B, S + 1], in multiples of 2^-2 below 8:
    # their partial sums (about 2^20) stay exact in float32
    e = torch.empty((b, s + 1), device=dev).exponential_(generator=g)
    e = torch.round(torch.clamp(e, max=7.75) * 4.0) / 4.0
    for x in (w, e):
        for mono in (False, True):
            exact(f"vbn_cumsum {tuple(x.shape)} monotone={mono}",
                  scan.cumsum_rows(x, mono), scan.cumsum_rows_plain(x, mono))
    rows = []

    def timed(name, replaces, fn, kernels, err, plain, lib, cost, **extra):
        row = kernel_row(name, tpu + replaces, launches.get(name[4:], 0), err,
                         device_ms(fn, RIS_REPS, kernels),
                         cuda_ms(plain, RIS_REPS), cost, src,
                         cuda_ms(lib, RIS_REPS))
        row["wrapper_ms"] = cuda_ms(fn, RIS_REPS)
        row.update(extra)
        return row

    # monotone, as norm_cum calls it: a sum and a max per entry; the sum
    # alone (the JAX _norm_cum's branch for S <= 2^20) timed beside it
    sum_only = device_ms(lambda: scan.cumsum_rows(w, False), RIS_REPS,
                         CUMSUM_KERNELS)
    rows.append(timed(
        "vbn_cumsum", "scan_pallas.py:33",
        lambda: scan.cumsum_rows(w, True), CUMSUM_KERNELS, errs["cumsum"],
        lambda: scan.cumsum_rows_plain(w, True),
        lambda: torch.cumsum(w, dim=1), (2 * b * s, 8 * b * s)))
    log("cumsum_monotone_cost", B=b, S=s, monotone_ms=rows[-1]["ms"],
        sum_only_ms=sum_only, extra_ms=rows[-1]["ms"] - sum_only)

    cum = rm.norm_cum(w)
    u0 = torch.rand((b, 1), generator=g, device=dev)
    q = rm.systematic_positions(u0, s, rm.T)
    k, kw = s // rm.T, s // rm.W
    c = scan.cumsum_rows(e, monotone=True)
    pos = (c[:, :s] / c[:, -1:]).contiguous()
    for tag, qq in (("systematic", q), ("multinomial", pos[:, :: rm.T])):
        exact(f"vbn_cum_index at S=2^20 {tag}", rm.cum_index(cum, qq),
              rm.cum_index_plain(cum, qq))
    # the pointer routine runs inside every merge launch of the served path
    # (its launches), and alone here, on its own entry point
    steps = int(np.ceil(np.log2(kw)))
    rows.append(timed(
        "vbn_cum_index", "resample_pallas.py:250",
        lambda: rm.cum_index(cum, q), ("cum_index_kernel",), errs["cum_index"],
        lambda: rm.cum_index_plain(cum, q),
        lambda: torch.searchsorted(cum[:, rm.W - 1 :: rm.W], q, right=True),
        (b * k * steps, 4 * (2 * b * kw + 2 * b * k)),
        launched_in="merge_kernel"))
    rows[-1]["launches"] = launches.get("srg", 0) + launches.get("spg", 0)

    u = rm.systematic_positions(u0, s)
    merge_ops = b * s * (int(np.log2(2 * rm.W)) + 3)
    for d in (1, 3):
        vals = torch.randn((b, s, d), generator=g, device=dev)
        exact(f"vbn_srg at S=2^20 D={d}", rm.srg(u0, cum, vals),
              rm.srg_plain(u0, cum, vals))
        nbytes = 4 * (b * s + b * s * d + b + b * s * d)
        row = timed(
            "vbn_srg", "resample_pallas.py:472",
            lambda: rm.srg(u0, cum, vals), ("merge_kernel",),
            errs["srg"], lambda: rm.srg_plain(u0, cum, vals),
            lambda: vals.gather(1, torch.searchsorted(cum, u, right=True)
                                .clamp_(max=s - 1)[..., None].expand(-1, -1, d)),
            (merge_ops, nbytes), D=d, grid=rm.merge_grid(b, s, d))
        if d == 1:
            rows.append(row)
        else:
            log("kernel_main_shape", kernel="vbn_srg", D=d, ms=row["ms"],
                wrapper_ms=row["wrapper_ms"], plain_ms=row["plain_ms"],
                library_ms=row["library_ms"], bound_ms=row["bound_ms"],
                grid=row["grid"])

    vals = torch.randn((b, s, 1), generator=g, device=dev)
    exact("vbn_spg at S=2^20", rm.spg(cum, pos, vals),
          rm.spg_plain(cum, pos, vals))
    log("resample_kernel_check", case="S=2^20 main shape", B=b, S=s,
        cumsum_shapes=[[b, s], [b, s + 1]], srg_D=[1, 3], spg_D=[1], ok=True)
    nbytes = 4 * (b * s + 2 * b * s + b * s)
    rows.append(timed(
        "vbn_spg", "resample_pallas.py:531",
        lambda: rm.spg(cum, pos, vals), ("merge_kernel",), errs["spg"],
        lambda: rm.spg_plain(cum, pos, vals),
        lambda: vals.gather(1, torch.searchsorted(cum, pos, right=True)
                            .clamp_(max=s - 1)[..., None]),
        (merge_ops, nbytes), grid=rm.merge_grid(b, s, 1, systematic=False)))
    for r in rows:
        log("kernel_main_shape", kernel=r["name"], ms=r["ms"],
            wrapper_ms=r["wrapper_ms"], plain_ms=r["plain_ms"],
            library_ms=r["library_ms"], bound_ms=r["bound_ms"],
            grid=r.get("grid"))
    return rows


def method_qps(vbn, q, b):
    """queries/s of one served batch (posterior, then its (mean, std) or
    pmf rows fetched to the host), best of SCAN_WINDOWS."""
    def serve():
        w, samples = vbn.infer_posterior(q)
        st = vbn._posterior_stats(w, samples.float())
        return st["mean"].cpu()

    serve()
    qps = []
    for _ in range(SCAN_WINDOWS):
        t0 = time.perf_counter()
        serve()
        qps.append(b / (time.perf_counter() - t0))
    return max(qps), qps, serve


def serve_resampling(bn, asia_vbn, lg_vbn, link):
    """Phases 10-14 (the resampling slice); returns the resampling kernels'
    rows of the kernel line."""
    t0 = time.perf_counter()
    errs = check_resample_kernels(lg_vbn.device)
    log("resample_kernel_check_done", max_abs_err=errs,
        seconds=time.perf_counter() - t0)
    launches = serve_ris(lg_vbn)
    serve_ris_asia(bn, asia_vbn)
    serve_is(lg_vbn, link)
    kernels = time_resample_kernels(lg_vbn.device, launches, errs)

    q = flagship_diag_query()
    out = {}
    for tag, name, kw in (
        ("ris_systematic", "resampled_importance_sampling",
         {"resample_method": "systematic"}),
        ("ris_multinomial", "resampled_importance_sampling",
         {"resample_method": "multinomial"}),
        ("is", "importance_sampling", {}),
    ):
        lg_vbn.set_inference_method(name, n_samples=S_RIS, **kw)
        out[tag] = method_qps(lg_vbn, q, B_RIS)[:2]
    link_bn, link_vbn, link_qs = link
    lq = [as_query(t, ev) for t, ev in link_qs]
    link_qps, link_w = dynamic_qps(lambda: link_vbn.infer_posterior_pmf(
        lq, n_classes=4, pad_bucket=N_DYN))
    log("end_to_end_resampling", B=B_RIS, S=S_RIS,
        **{f"{k}_qps": v[0] for k, v in out.items()},
        **{f"{k}_window_qps": v[1] for k, v in out.items()},
        is_dynamic_link724_qps=link_qps, is_dynamic_link724_window_qps=link_w,
        is_dynamic_S=S_IS_DYN)
    lg_vbn.set_inference_method("resampled_importance_sampling",
                                n_samples=S_RIS, resample_method="systematic")
    serve = method_qps(lg_vbn, q, B_RIS)[2]
    log("serve_profile", workload="flagship RIS systematic", **profile_batch(
        serve, ("cumsum_tile_kernel", "cumsum_kernel", "merge_kernel")))
    return kernels


# ---------------------------------------------------------------------------
# The KDE slice: KDE CPDs on the four KDE kernels
# ---------------------------------------------------------------------------


KDE_POINTS = 2048  # max_points of the vbn_kde_lw_dyn preset (presets.py:154-160)
B_KDE, S_KDE = 8, 1 << 20  # W1, W2, MCM: r2_measure.py's BASELINE point
S_KDE_DYN = 1 << 16  # W3 and W4
N_KDE_DYN = 96  # W3's queries, one batch
M_KDE_CHECK = 1 << 14  # query rows of the kernel checks
M_KDE_STATS = 1 << 20  # picks drawn for the pick statistics
KDE_ROWS = 1 << 16  # rows per library call, and of a plain version's warm-up
KDE_REPS = 3  # kernel launches per CUDA-event window
KDE_NAMES = ("kde_root", "kde_cond", "kde_cond_wide", "kde_pick")


def fit_kde(vbn_cls, defaults, dag, data, seed=0):
    """The port's fit of a network of KDE CPDs (max_points KDE_POINTS,
    Scott bandwidths) on ``data``."""
    vbn = vbn_cls(dag, seed=seed)
    vbn.set_learning_method("node_wise", nodes_cpds={
        k: dict(defaults.cpd("kde"), max_points=KDE_POINTS) for k in data})
    vbn.fit(data)
    return vbn


def wide_data(n=4096, seed=11):
    """W4: z a 39-dim root, t a 1-dim root, y = t + 0.1 mean(z) + 0.1 noise."""
    g = np.random.default_rng(seed)
    z = g.normal(size=(n, 39))
    t = g.normal(size=n)
    return {"z": z, "t": t, "y": t + 0.1 * z.mean(axis=1) + 0.1 * g.normal(size=n)}


def kde_support(g, n, dx, dp, valid, dev):
    """A random support: N points, the first ``valid`` live, the rest at the
    model's soft mask log(1e-20)."""
    import torch

    data_x = torch.randn((n, dx), generator=g, device=dev)
    data_p = torch.randn((n, dp), generator=g, device=dev)
    lm = torch.zeros(n, device=dev)
    lm[valid:] = float(np.log(np.float32(1e-20)))
    return data_x, data_p, lm


def pick_agreement(got, want, data_x, data_p, lm, p_scale, parents=None):
    """How two inverse-CDF picks of the same rows agree: (share of rows
    with the same point, rows that differ, the largest share of a row's
    weight that lies strictly between two differing picks in the walk,
    in float64). ``data_x``'s first feature names its support point."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import kde_fused as kf

    order = torch.argsort(data_x[:, 0])
    key = data_x[order, 0].contiguous()

    def index(out):
        i = order[torch.searchsorted(key, out[:, 0].contiguous())]
        bad = torch.nonzero((data_x[i] != out).any(dim=1))[:, 0]
        if len(bad):  # support rows that share their first feature
            eq = (data_x[None, :, :] == out[bad][:, None, :]).all(dim=-1)
            if not bool(eq.any(dim=1).all()):
                raise AssertionError("a pick is not a row of the support")
            i[bad] = eq.int().argmax(dim=1)
        return i

    gi, wi = index(got), index(want)
    diff = torch.nonzero(gi != wi)[:, 0]
    worst = 0.0
    if len(diff):
        s = lm.double()[None, :].expand(len(diff), -1)
        if parents is not None and parents.shape[1]:
            inv2p, _ = kf.kernel_consts(parents.shape[1], p_scale)
            sq = ((parents[diff].double()[:, None, :]
                   - data_p.double()[None, :, :]) ** 2).sum(-1)
            s = s - sq * float(inv2p)
        cum = torch.cumsum(torch.exp(s - s.max(dim=1, keepdim=True).values), 1)
        a = torch.minimum(gi, wi)[diff][:, None]
        b = torch.maximum(gi, wi)[diff][:, None]
        between = cum.gather(1, b - 1) - cum.gather(1, a)
        worst = float((between[:, 0] / cum[:, -1]).max())
    return float((gi == wi).double().mean()), len(diff), worst


def kde_cond_float64(x, p, data_x, data_p, log_mask, y_scale, p_scale):
    """``lse_n(kp + ky) - lse_n(kp)`` in float64, 1024 rows at a time."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import kde_fused as kf

    inv2y, cy = kf.kernel_consts(x.shape[1], y_scale)
    inv2p, cp = kf.kernel_consts(p.shape[1], p_scale)
    dx, dp, lm = data_x.double(), data_p.double(), log_mask.double()
    out = []
    for r in range(0, x.shape[0], 1024):
        kp = (-torch.cdist(p[r:r + 1024].double(), dp) ** 2 * inv2p + cp
              + lm[None])
        ky = -torch.cdist(x[r:r + 1024].double(), dx) ** 2 * inv2y + cy
        out.append(torch.logsumexp(kp + ky, 1) - torch.logsumexp(kp, 1))
    return torch.cat(out)


FAR_TERM = 120.0  # a far query's target term at its own support point
FAR_OUT = (100.0, 160.0)  # the far rows' |log-density|


def far_queries(data_x, data_p, idx, ys, ps, gen, ref_fn):
    """Queries far off the support: support point ``idx`` moved by k
    bandwidths in every target feature, k = sqrt(2 FAR_TERM / Dx) at first
    (that point's target term -FAR_TERM), and by one bandwidth in every
    parent feature, each move's sign at random. Kept are the rows whose
    float64 log-density ``ref_fn(x, p)`` lies in -FAR_OUT (past 100, short
    of 160: toward 200 the plain version itself drifts to ~9e-5 from
    float64, and 1e-4 against it stops measuring the kernel); while fewer
    than a quarter are kept (nearer points lift a row of a narrow target),
    k grows by a tenth. Returns (x, p, ref) of the kept rows."""
    import torch

    m, dx, dp = idx.shape[0], data_x.shape[1], data_p.shape[1]
    dev = data_x.device
    sx = torch.sign(torch.randn((m, dx), generator=gen, device=dev))
    p = data_p[idx] + ps * torch.sign(
        torch.randn((m, dp), generator=gen, device=dev))
    k = (2.0 * FAR_TERM / dx) ** 0.5
    for _ in range(40):
        x = data_x[idx] + k * ys * sx
        ref = ref_fn(x, p)
        keep = (ref.abs() > FAR_OUT[0]) & (ref.abs() < FAR_OUT[1])
        if int(keep.sum()) >= m // 4:
            return x[keep], p[keep], ref[keep]
        k *= 1.1
    raise AssertionError("no far query set with a quarter of its rows past 100")


def check_wide_off_support(dev, m):
    """vbn_kde_cond_wide with wide targets (the GEMM takes them) at Scott
    bandwidths: its m query rows one bandwidth off a support point in every
    feature (outputs at 50-80, each term far below 0), and far off the
    support (``far_queries``: outputs past 100); within 1e-4 of the plain
    version and of float64 (the plain version against float64 logged).
    Returns the max abs error against the plain version."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import kde_fused as kf

    g = torch.Generator(device=dev).manual_seed(98)
    worst = 0.0
    for dx, dp in ((35, 3), (40, 8), (40, 40)):
        n, valid = 2000, 1700
        data_x, data_p, lm = kde_support(g, n, dx, dp, valid, dev)
        rate = float(valid) ** (-1.0 / (dx + dp + 4))
        ys = rate * float(data_x[:valid].std(0).mean())
        ps = rate * float(data_p[:valid].std(0).mean())
        for case in ("off_support", "far"):
            idx = torch.randint(0, valid, (m,), generator=g, device=dev)
            ref_fn = lambda x, p: kde_cond_float64(  # noqa: E731
                x, p, data_x, data_p, lm, ys, ps)
            if case == "far":
                x, p, ref = far_queries(data_x, data_p, idx, ys, ps, g, ref_fn)
            else:
                x = data_x[idx] + ys * torch.sign(
                    torch.randn((m, dx), generator=g, device=dev))
                p = data_p[idx] + ps * torch.sign(
                    torch.randn((m, dp), generator=g, device=dev))
                ref = ref_fn(x, p)
            got = kf.kde_cond_wide(x, p, data_x, data_p, lm, ys, ps)
            want = kf.kde_cond_plain(x, p, data_x, data_p, lm, ys, ps)
            err = compare(f"vbn_kde_cond_wide {case} Dx={dx} Dp={dp}",
                          got, want, atol=1e-4)
            worst = max(worst, err)
            k64 = float((got.double() - ref).abs().max())
            log("kde_kernel_check", kernel="vbn_kde_cond_wide", case=case,
                N=n, valid=valid, Dx=dx, Dp=dp, M=int(x.shape[0]),
                max_abs_err=err, kernel_vs_float64=k64,
                plain_vs_float64=float((want.double() - ref).abs().max()),
                min_abs_out=float(ref.abs().min()),
                max_abs_out=float(ref.abs().max()), ok=True)
            if not k64 <= 1e-4:
                raise AssertionError(f"vbn_kde_cond_wide {case} Dx={dx} "
                                     f"Dp={dp}: {k64} from float64")
    return worst


def check_kde_kernels(dev):
    """The four KDE kernels against their plain versions at M_KDE_CHECK
    rows, N = 2048 and 2000 (its last 300 points masked), Dx in {1, 2}, Dp
    in {0, 1, 2, 3, 40}: log-densities within 1e-4, picks exact with an
    external Gumbel field, and on the served inverse-CDF route the same
    pick on >= 99.99 % of M_KDE_STATS rows (any other a neighbour in the
    walk: the points between carry <= 1e-5 of the row's weight); the wide
    conditional with wide targets off the support (``check_wide_off_support``);
    then the pick statistics. Returns the max abs error per kernel."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import kde_fused as kf

    g = torch.Generator(device=dev).manual_seed(99)
    m = M_KDE_CHECK
    errs = dict.fromkeys(KDE_NAMES, 0.0)
    key = kf.pick_key(g, dev)
    worst_agree = 1.0
    for n, valid in ((2048, 2048), (2000, 1700)):
        for dx in (1, 2):
            for dp in (0, 1, 2, 3, 40):
                data_x, data_p, lm = kde_support(g, n, dx, max(dp, 1), valid, dev)
                x = 1.5 * torch.randn((m, dx), generator=g, device=dev)
                p = 1.5 * torch.randn((m, max(dp, 1)), generator=g, device=dev)
                ys, ps = 0.3 * np.sqrt(dx), 0.4 * np.sqrt(max(dp, 1))
                tag = f"N={n} valid={valid} Dx={dx} Dp={dp}"
                if dp == 0:
                    name, got = "kde_root", kf.kde_root(x, data_x, lm, ys)
                    want = kf.kde_root_plain(x, data_x, lm, ys)
                else:
                    name = "kde_cond_wide" if dp > kf._DIRECT_D else "kde_cond"
                    got = getattr(kf, name)(x, p, data_x, data_p, lm, ys, ps)
                    want = kf.kde_cond_plain(x, p, data_x, data_p, lm, ys, ps)
                errs[name] = max(errs[name], compare(
                    f"vbn_{name} {tag}", got, want, atol=1e-4))
                if dp <= kf._DIRECT_D:  # wider picks take the chunked form
                    par = p if dp else None
                    gum = -torch.log(torch.empty((m, n), device=dev)
                                     .exponential_(generator=g))
                    exact(f"vbn_kde_pick {tag} external Gumbel",
                          kf.kde_pick(key, par, data_p, data_x, lm, ps, m,
                                      gumbel=gum),
                          kf.kde_pick_plain(key, par, data_p, data_x, lm, ps,
                                            m, gumbel=gum))
                    del gum
                    # the served route, on M_KDE_STATS rows from one key
                    pb = 1.5 * torch.randn((M_KDE_STATS, max(dp, 1)),
                                           generator=g, device=dev)
                    par = pb if dp else None
                    agree = pick_agreement(
                        kf.kde_pick(key, par, data_p, data_x, lm, ps, M_KDE_STATS),
                        kf.kde_pick_plain(key, par, data_p, data_x, lm, ps,
                                          M_KDE_STATS),
                        data_x, data_p, lm, ps, par)
                    worst_agree = min(worst_agree, agree[0])
                    if agree[0] < 0.9999 or agree[2] > 1e-5:
                        raise AssertionError(f"vbn_kde_pick {tag}: agreement {agree}")
                log("kde_kernel_check", kernel=f"vbn_{name}", N=n, valid=valid,
                    Dx=dx, Dp=dp, M=m, max_abs_err=errs[name],
                    pick=None if dp > kf._DIRECT_D else {
                        "external_gumbel": "exact", "rows": M_KDE_STATS,
                        "same_pick_share": agree[0], "rows_differing": agree[1],
                        "weight_between_differing_picks": agree[2]},
                    ok=True)
    errs["kde_cond_wide"] = max(errs["kde_cond_wide"],
                                check_wide_off_support(dev, m))
    # pick statistics over M_KDE_STATS in-kernel draws: a flat mask gives a
    # uniform pick (chi-square), a 0.75/0.25 two-point mask its weights, and
    # a conditional pick for one parent row the exact categorical
    n = 2048
    vals = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    none_p = torch.zeros((n, 0), device=dev)
    picks = kf.kde_pick(kf.pick_key(g, dev), None, none_p, vals,
                        torch.zeros(n, device=dev), 1.0, M_KDE_STATS)
    counts = torch.bincount(picks[:, 0].long(), minlength=n).double()
    e = M_KDE_STATS / n
    chi2_z = float((((counts - e) ** 2 / e).sum() - (n - 1)) / np.sqrt(2 * (n - 1)))
    lm = torch.full((n,), float(np.log(np.float32(1e-20))), device=dev)
    lm[5], lm[1500] = float(np.log(0.75)), float(np.log(0.25))
    picks = kf.kde_pick(kf.pick_key(g, dev), None, none_p, vals, lm, 1.0,
                        M_KDE_STATS)[:, 0]
    frac = float((picks == 5).double().mean())
    frac_z = (frac - 0.75) / np.sqrt(0.75 * 0.25 / M_KDE_STATS)
    stray = int(((picks != 5) & (picks != 1500)).sum())
    _x, data_p, lm = kde_support(g, n, 1, 2, 1700, dev)
    p_row = torch.tensor([[0.3, -0.5]], device=dev)
    probs = torch.softmax(lm.double() - ((p_row.double() - data_p.double()) ** 2)
                          .sum(1) / (2 * 0.5 ** 2), 0)
    picks = kf.kde_pick(kf.pick_key(g, dev), p_row.expand(M_KDE_STATS, 2)
                        .contiguous(), data_p, vals, lm, 0.5, M_KDE_STATS)
    cond_z = chi2_z_merged(torch.bincount(picks[:, 0].long(), minlength=n)
                           .double().cpu().numpy(), probs.cpu().numpy())
    log("kde_pick_statistics", M=M_KDE_STATS, uniform_chi2_z=chi2_z,
        two_point_frac=frac, two_point_z=frac_z, stray_picks=stray,
        conditional_chi2_z=cond_z, worst_same_pick_share=worst_agree)
    if abs(chi2_z) > 6 or abs(frac_z) > 6 or stray or abs(cond_z) > 6:
        raise AssertionError(f"pick statistics off: chi2 z {chi2_z}, "
                             f"two-point z {frac_z}, stray {stray}, "
                             f"conditional chi2 z {cond_z}")
    return errs


def chi2_z_merged(counts, probs):
    """(chi-square - dof) / sd of ``counts`` against ``probs``, the cells
    of expected count under 5 merged into one."""
    e = probs * counts.sum()
    small = e < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(e[~small], e[small].sum())
    keep = exp > 0
    chi2 = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    dof = int(keep.sum()) - 1
    return (chi2 - dof) / np.sqrt(2 * dof)


def kde_node(vbn, node):
    """(data_x, data_p, y_scale, p_scale) of a fitted KDE node: its valid
    support in float64."""
    p, cpd = vbn.params[node], vbn.nodes[node]
    keep = p["valid"] > 0
    return (p["data_x"][keep].double(), p["data_p"][keep].double(),
            cpd._y_scale(), cpd._p_scale())


def _log_kernel(q, data, h):
    """log of the unnormalized Gaussian kernel, [G, D] x [N, D] -> [G, N]."""
    d2 = ((q[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    return -d2 / (2.0 * h * h)


def _parents_cols(vbn, node, values):
    """[G, Dp] parents of ``node`` from {parent: [G] tensor}, in its
    parents' order."""
    import torch

    return torch.stack([values[p] for p in vbn.dag.parents(node)], dim=1)


def _std(mean, e2):
    return float(np.sqrt(max(e2 - mean * mean, 0.0)))


def kde_reference(vbn, kind, rows):
    """Float64 (mean, std) per row of the fitted KDE flagship's posterior,
    in plain torch on the card. ``w1``: x2 | x0 = a, x1 marginalized by
    quadrature on 2048 points; ``w2``: x0 | x2 = c on a 512 x 512 grid over
    (x0, x1); ``mcm``: x2 | x0 = a, x1 = b in closed form. MCM weights each
    draw by its density p, so its estimand is the mean and spread of p^2:
    with p = sum_n w_n N(dx_n, h^2), p^2 = sum_nk w_n w_k N(dx_n; dx_k, 2h^2)
    N((dx_n + dx_k) / 2, h^2 / 2)."""
    import torch

    f64 = dict(dtype=torch.float64, device=vbn.device)
    dx2, dp2, hy2, hp2 = kde_node(vbn, "x2")
    d2 = dx2[:, 0]
    out = []
    if kind == "w1":
        d1, _, h1, _ = kde_node(vbn, "x1")
        grid = torch.linspace(float(d1.min()) - 8 * h1, float(d1.max()) + 8 * h1,
                              2048, **f64)
        prior = torch.softmax(torch.logsumexp(_log_kernel(grid[:, None], d1, h1),
                                              dim=1), dim=0)
        for a in rows:
            par = _parents_cols(vbn, "x2", {"x0": torch.full_like(grid, a),
                                            "x1": grid})
            w = torch.softmax(_log_kernel(par, dp2, hp2), dim=1)
            m1, m2 = w @ d2, w @ d2**2 + hy2**2
            mean = float(prior @ m1)
            out.append((mean, _std(mean, float(prior @ m2))))
    elif kind == "w2":
        d0, _, h0, _ = kde_node(vbn, "x0")
        d1, _, h1, _ = kde_node(vbn, "x1")
        g0 = torch.linspace(float(d0.min()) - 8 * h0, float(d0.max()) + 8 * h0,
                            512, **f64)
        g1 = torch.linspace(float(d1.min()) - 8 * h1, float(d1.max()) + 8 * h1,
                            512, **f64)
        lp0 = torch.logsumexp(_log_kernel(g0[:, None], d0, h0), dim=1)
        lp1 = torch.logsumexp(_log_kernel(g1[:, None], d1, h1), dim=1)
        cols = vbn.dag.parents("x2")
        i0, i1 = cols.index("x0"), cols.index("x1")
        a1 = -(g1[:, None] - dp2[None, :, i1]) ** 2 / (2 * hp2 * hp2)  # [512, N]
        for c in rows:
            ly = -(c - d2) ** 2 / (2 * hy2 * hy2)  # [N]
            logw = []
            for s0 in range(0, 512, 32):  # 32 x 512 grid points at a time
                a0 = -(g0[s0:s0 + 32, None] - dp2[None, :, i0]) ** 2 / (2 * hp2 * hp2)
                lw = a0[:, None, :] + a1[None, :, :]  # [32, 512, N]
                lik = torch.logsumexp(lw + ly, -1) - torch.logsumexp(lw, -1)
                logw.append(lp0[s0:s0 + 32, None] + lp1[None, :] + lik)
            w = torch.softmax(torch.cat(logw).reshape(-1), 0).reshape(512, 512)
            w0 = w.sum(dim=1)
            mean = float(w0 @ g0)
            out.append((mean, _std(mean, float(w0 @ g0**2))))
    else:
        for a, b in rows:
            par = _parents_cols(vbn, "x2", {"x0": torch.tensor([a], **f64),
                                            "x1": torch.tensor([b], **f64)})
            w = torch.softmax(_log_kernel(par, dp2, hp2)[0], dim=0)
            lw2 = (torch.log(w)[:, None] + torch.log(w)[None, :]
                   - (d2[:, None] - d2[None, :]) ** 2 / (4 * hy2 * hy2))
            ww = torch.softmax(lw2.reshape(-1), 0).reshape(lw2.shape)
            mid = (d2[:, None] + d2[None, :]) / 2
            mean = float((ww * mid).sum())
            e2 = float((ww * (mid**2 + hy2 * hy2 / 2)).sum())
            out.append((mean, _std(mean, e2)))
    return np.asarray(out)


def kde_accuracy(served, ref):
    """Worst |d mean| / std and |d std| / std of served (mean, std) rows
    against the reference's."""
    return {"dmean_over_std": float(np.max(np.abs(served[:, 0] - ref[:, 0]) / ref[:, 1])),
            "dstd_over_std": float(np.max(np.abs(served[:, 1] - ref[:, 1]) / ref[:, 1]))}


def kde_flagship_queries():
    """W1 (x2 | x0), W2 (x0 | x2) and MCM (x2 | x0, x1) at B_KDE rows."""
    v = np.linspace(-1, 1, B_KDE).reshape(B_KDE, 1).astype(np.float32)
    return ({"target": "x2", "evidence": {"x0": v}},
            {"target": "x0", "evidence": {"x2": v}},
            {"target": "x2", "evidence": {"x0": v, "x1": v[::-1].copy()}})


def add_launches(total, got, names=KDE_NAMES):
    for k in names:
        total[k] = total.get(k, 0) + got.get(k, 0)


def serve_kde_main_path(vbn, total):
    """W1, W2 and MCM through ``infer_posterior_moments``, each with the
    counters reset just before and read just after, each held against the
    float64 reference of the fitted model; W1's peak device memory."""
    import torch

    w1, w2, mcm = kde_flagship_queries()
    v = w1["evidence"]["x0"][:, 0].astype(np.float64)
    cases = (
        ("W1 kde_flagship_lw", "likelihood_weighting", w1,
         {"kde_root": 1, "kde_pick": 2, "uniforms": SOME}, ("w1", v)),
        ("W2 kde_flagship_diag", "likelihood_weighting", w2,
         {"kde_pick": 2, "kde_cond": 1, "uniforms": SOME}, ("w2", v)),
        ("MCM x2 | x0, x1", "monte_carlo_marginalization", mcm,
         {"kde_pick": 1, "kde_cond": 1, "uniforms": SOME},
         ("mcm", list(zip(v, v[::-1])))),
    )
    for tag, method, q, expect, (kind, ref_rows) in cases:
        vbn.set_inference_method(method, n_samples=S_KDE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        rows, _ = vbn.infer_posterior_moments([q])
        launches = read_launches(expect)
        mem = torch.cuda.max_memory_allocated()
        path = vbn._last_summary_path
        if rows.shape != (B_KDE, 2) or not np.isfinite(rows).all():
            raise AssertionError(f"{tag}: moments rows bad {rows.shape}")
        ref = kde_reference(vbn, kind, ref_rows)
        acc = kde_accuracy(rows, ref)
        log("kde_main_path", workload=tag, B=B_KDE, S=S_KDE, launches=launches,
            summary_path=path, max_memory_allocated_bytes=mem,
            served=rows.tolist(), reference=ref.tolist(), limit=0.05, **acc)
        if path != "stream":
            raise AssertionError(f"{tag}: summary path {path} != stream")
        if acc["dmean_over_std"] > 0.05 or acc["dstd_over_std"] > 0.05:
            raise AssertionError(f"{tag} off the fitted model: {acc}")
        add_launches(total, launches)


def gauss8_kde(vbn_cls, defaults):
    """W3's network, fit and queries: random_gaussian(8, seed=0) on 4096
    rows, its 96 queries (seed 2) as single-row query dicts."""
    from benchmarking.gaussian_bn import (
        generate_gaussian_inference_queries,
        random_gaussian,
    )

    gbn = random_gaussian(8, seed=0)
    vbn = fit_kde(vbn_cls, defaults, {n: gbn.parents[n] for n in gbn.nodes},
                  gbn.sample(4096, seed=1))
    vbn.set_inference_method("likelihood_weighting", n_samples=S_KDE_DYN,
                             dynamic_masks=True)
    queries = generate_gaussian_inference_queries(gbn, n_queries=N_KDE_DYN, seed=2)
    qd = [{"target": q.target,
           "evidence": {k: np.array([[float(v)]], np.float32)
                        for k, v in q.evidence.items()}} for q in queries]
    return gbn, vbn, queries, qd


def gauss_kl(gbn, queries, mom, spans):
    """KL of each served (mean, std) against the true Gaussian posterior,
    over the on-manifold and empty queries."""
    kls = []
    for q, (lo, _hi, _t) in zip(queries, spans):
        if q.evidence_mode == "off_manifold":
            continue
        m, s = gbn.conditional(q.target, q.evidence)
        s1, s2 = max(float(mom[lo][1]), 1e-6), max(s, 1e-6)
        kls.append(float(np.log(s2 / s1) + (s1**2 + (float(mom[lo][0]) - m) ** 2)
                         / (2 * s2**2) - 0.5))
    return {"kl_median": float(np.median(kls)), "kl_mean": float(np.mean(kls)),
            "kl_max": float(np.max(kls)), "queries_scored": len(kls)}


def serve_kde_dynamic(gbn, vbn, queries, qd, total):
    """W3: the 96 queries as one mask-dynamic batch; KL against the exact
    posterior over the on-manifold and empty queries."""
    import torch

    roots = sum(1 for n in gbn.nodes if not gbn.parents[n])
    expect = {"kde_pick": len(gbn.nodes), "kde_root": roots,
              "kde_cond": len(gbn.nodes) - roots, "uniforms": SOME}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mom, spans = vbn.infer_posterior_moments(qd, pad_bucket=N_KDE_DYN)
    launches = read_launches(expect)
    mem = torch.cuda.max_memory_allocated()
    if mom.shape != (N_KDE_DYN, 2) or not np.isfinite(mom).all():
        raise AssertionError(f"W3 moments rows bad: {mom.shape}")
    acc = gauss_kl(gbn, queries, mom, spans)
    log("kde_dynamic", workload="W3 kde_gauss8_dyn", queries=N_KDE_DYN,
        S=S_KDE_DYN, launches=launches, summary_path=vbn._last_summary_path,
        max_memory_allocated_bytes=mem, limits={"kl_median": 0.02, "kl_mean": 0.1},
        **acc)
    if acc["kl_median"] > 0.02 or acc["kl_mean"] > 0.1:
        raise AssertionError(f"W3 KL over the limits: {acc}")
    add_launches(total, launches)


def w4_query():
    """W4's query: LW t | y at B_KDE rows (y = linspace(-1, 1))."""
    return {"target": "t", "evidence": {
        "y": np.linspace(-1, 1, B_KDE).reshape(B_KDE, 1).astype(np.float32)}}


def serve_kde_wide(vbn, total):
    """W4: LW t | y on the 40-parent-feature KDE node, B_KDE rows at
    S_KDE_DYN; the wide kernel's launch recorded, and held against its
    plain version on that launch's own inputs (first M_KDE_CHECK rows)."""
    from vectorizedbayesiannetwork_torch.ops import kde_fused as kf
    from vectorizedbayesiannetwork_torch.ops import kde_kernel

    vbn.set_inference_method("likelihood_weighting", n_samples=S_KDE_DYN)
    q = w4_query()
    rec = {}
    launch = kde_kernel.kde_cond_wide

    def recording(*args):
        rec["args"], rec["out"] = args, launch(*args)
        return rec["out"]

    kde_kernel.kde_cond_wide = recording
    try:
        reset_launches()
        rows, _ = vbn.infer_posterior_moments([q])
        launches = read_launches({"kde_pick": 2, "kde_cond_wide": 1,
                                  "uniforms": SOME})
    finally:
        kde_kernel.kde_cond_wide = launch
    x, p, data_x, data_p, lm, ys, ps = rec["args"]
    r = M_KDE_CHECK
    err = compare("vbn_kde_cond_wide on W4's launch", rec["out"][:r],
                  kf.kde_cond_plain(x[:r], p[:r], data_x, data_p, lm, ys, ps),
                  atol=1e-4)
    log("kde_wide", workload="W4 kde_wide", B=B_KDE, S=S_KDE_DYN,
        launches=launches, parent_features=p.shape[1], moments=rows.tolist(),
        wide_kernel_vs_plain_max_abs_err=err)
    if rows.shape != (B_KDE, 2) or not np.isfinite(rows).all():
        raise AssertionError(f"W4 moments rows bad: {rows}")
    add_launches(total, launches)
    return rec["args"], err


def kde_cost(kind, m, n, dx, dp):
    """(float32 operations, bytes, SFU operations, tensor-core flops, M) of
    one KDE launch's function, per pair of a query row and a support point.
    The log-densities: a multiply-add per feature (2 flops, one TF32 pass
    on the tensor cores, which can take them: the function's count, not a
    design's three passes), then for the root 4 more float32 operations
    (scale, mask, the logsumexp's compare and exp argument) and 1 exp; for
    the conditional kernels 8 more and 2 exps. The pick's function is one
    draw a row from the parent-softmax categorical, whatever the design: 2
    float32 operations per feature and 6 more a pair (scale, mask, exp
    argument, the running sum and its compare with the row's threshold)
    and 1 exp (a root's weights do not depend on the row: once per support
    point), per row one uniform (a quarter of a Philox-4x32-10 call, 25,
    and 3) and the copy of its Dx values. Bytes: each input read once
    (queries, support, mask, key), each output written once."""
    pairs = m * n
    if kind == "root":
        return 4 * pairs, 4 * (m * dx + m + n * (dx + 1)), pairs, 2 * dx * pairs, m
    if kind == "pick":
        w = pairs if dp else n
        return ((2 * dp + 6) * w + (28 + dx) * m,
                4 * (m * dp + n * (dp + dx + 1) + m * dx) + 16, w, 0, m)
    return (8 * pairs, 4 * (m * (dx + dp + 1) + n * (dx + dp + 1)), 2 * pairs,
            2 * (dx + dp) * pairs, m)



def once_ms(fn, warm):
    """(ms, result) of one call of ``fn()`` (CUDA events), after one call
    of ``warm()`` on a slice of the same inputs."""
    import torch

    warm()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def library_ms(fn, total):
    """ms of ``fn(r0, r1)`` over all ``total`` rows, KDE_ROWS rows a call
    (the library compositions hold [rows, N] tensors), after one warm-up
    slice."""
    def run():
        for r0 in range(0, total, KDE_ROWS):
            fn(r0, min(r0 + KDE_ROWS, total))

    return once_ms(run, lambda: fn(0, min(KDE_ROWS, total)))[0]


def time_kde_kernels(flag, wide_args, launches, errs):
    """Each KDE kernel at its workload's shape (root and Dp=2 pick: W1; the
    conditional: W2; the wide conditional: W4's recorded launch): the
    kernel's ms, its plain version's ms over all M rows (which also holds
    the kernel over them), one library composition's ms over all M rows,
    and the bound."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import kde_fused as kf

    dev = flag.device
    g = torch.Generator(device=dev).manual_seed(5)
    m, r = B_KDE * S_KDE, KDE_ROWS
    src = "vectorizedbayesiannetwork_torch/csrc/kde.cu"
    tpu = "vectorizedbayesiannetwork_tpu/ops/kde_pallas.py:"
    ev = torch.linspace(-1, 1, B_KDE, device=dev).repeat_interleave(S_KDE)[:, None]
    drawn = torch.randn((m, 1), generator=g, device=dev)
    par = torch.cat([ev, drawn], dim=1)  # x2's parents (x0, x1) in W1 and W2
    rows = []

    def lm_of(node):
        return flag.nodes[node]._log_mask(flag.params[node])

    def row(name, line, kernel, plain, library, cost, err, held=None):
        """Time ``kernel()`` over its launch's M rows, then ``plain(r0, r1)``
        over all of them in one call (held against the kernel there: within
        1e-4, or by ``held(got, want)``), then ``library(r0, r1)`` over all
        of them, KDE_ROWS rows a call."""
        total = cost[4]
        ms = cuda_ms(kernel, KDE_REPS)
        got = kernel()
        plain_ms, want = once_ms(lambda: plain(0, total),
                                 lambda: plain(0, min(r, total)))
        if held is not None:
            held(got, want)
        else:
            err = max(err, compare(f"vbn_{name} at the main shape", got, want,
                                   atol=1e-4))
        del got, want
        lib_ms = library_ms(library, total)
        out = kernel_row(f"vbn_{name}", tpu + line, launches.get(name, 0), err,
                         ms, plain_ms, cost[:4], src, lib_ms)
        # the bound with every feature operation at the float32 rate
        out.update(M=total, fp32_features_bound_ms=bound(
            (cost[0] + cost[3], cost[1], cost[2]))[0])
        log("kernel_main_shape", kernel=f"vbn_{name}", M=total, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=out["bound_ms"])
        rows.append(out)
        return out

    # root log-density: W1's evidence x0 through x0's fit
    dx0, lm0 = flag.params["x0"]["data_x"], lm_of("x0")
    hy0 = flag.nodes["x0"]._y_scale()
    inv2y, const_y = kf.kernel_consts(1, hy0)
    row("kde_root", "147",
        lambda: kf.kde_root(ev, dx0, lm0, hy0),
        lambda a, b: kf.kde_root_plain(ev[a:b], dx0, lm0, hy0),
        lambda a, b: torch.logsumexp(-torch.cdist(ev[a:b], dx0) ** 2 * float(inv2y)
                                     + float(const_y) + lm0, dim=1),
        kde_cost("root", m, dx0.shape[0], 1, 0), errs["kde_root"])

    # conditional: W2's evidence x2 given (x0, x1) through x2's fit
    p2 = flag.params["x2"]
    dx2, dp2, lm2 = p2["data_x"], p2["data_p"], lm_of("x2")
    hy2, hp2 = flag.nodes["x2"]._y_scale(), flag.nodes["x2"]._p_scale()

    def lib_cond(x, p, dx, dp, lm, ys, ps):
        iy, cy = kf.kernel_consts(x.shape[1], ys)
        ip, cp = kf.kernel_consts(p.shape[1], ps)
        kp = -torch.cdist(p, dp) ** 2 * float(ip) + float(cp) + lm
        ky = -torch.cdist(x, dx) ** 2 * float(iy) + float(cy)
        return torch.logsumexp(kp + ky, dim=1) - torch.logsumexp(kp, dim=1)

    row("kde_cond", "106",
        lambda: kf.kde_cond(ev, par, dx2, dp2, lm2, hy2, hp2),
        lambda a, b: kf.kde_cond_plain(ev[a:b], par[a:b], dx2, dp2, lm2, hy2, hp2),
        lambda a, b: lib_cond(ev[a:b], par[a:b], dx2, dp2, lm2, hy2, hp2),
        kde_cost("cond", m, dx2.shape[0], 1, 2), errs["kde_cond"])

    # wide conditional: W4's own launch
    x, p, dxw, dpw, lmw, ysw, psw = wide_args
    row("kde_cond_wide", "72",
        lambda: kf.kde_cond_wide(x, p, dxw, dpw, lmw, ysw, psw),
        lambda a, b: kf.kde_cond_plain(x[a:b], p[a:b], dxw, dpw, lmw, ysw, psw),
        lambda a, b: lib_cond(x[a:b], p[a:b], dxw, dpw, lmw, ysw, psw),
        kde_cost("cond", x.shape[0], dxw.shape[0], x.shape[1], p.shape[1]),
        errs["kde_cond_wide"])

    # pick: W1's draw of x2 given (x0, x1) on the served route; the plain
    # version draws from the same per-row uniforms (rows from 0, one call)
    key = kf.pick_key(g, dev)
    inv2p, _ = kf.kernel_consts(2, hp2)
    agreement = {}

    def lib_pick(a, b):
        u = torch.rand((b - a, dx2.shape[0]), generator=g, device=dev)
        s = -torch.cdist(par[a:b], dp2) ** 2 * float(inv2p) + lm2
        return dx2[torch.argmax(s - torch.log(-torch.log(u)), dim=1)]

    def held_pick(data_p, lm, ps, parents):
        def held(got, want):
            agree = pick_agreement(got, want, dx2 if parents is not None else
                                   p1["data_x"], data_p, lm, ps, parents)
            agreement["root" if parents is None else "Dp=2"] = agree
            if agree[0] < 0.9999 or agree[2] > 1e-5:
                raise AssertionError(f"vbn_kde_pick at the main shape: {agree}")
        return held

    p1 = flag.params["x1"]
    out = row("kde_pick", "390",
              lambda: kf.kde_pick(key, par, dp2, dx2, lm2, hp2, m),
              lambda a, b: kf.kde_pick_plain(key, par[a:b], dp2, dx2, lm2, hp2,
                                             b - a),
              lib_pick, kde_cost("pick", m, dx2.shape[0], 1, 2),
              errs["kde_pick"], held=held_pick(dp2, lm2, hp2, par))
    # the root pick (x1, W1's other draw): the CDF form
    n1, lm1 = p1["data_x"].shape[0], lm_of("x1")
    root = lambda: kf.kde_pick(key, None, p1["data_p"], p1["data_x"], lm1,  # noqa: E731
                               1.0, m)
    root_ms = cuda_ms(root, KDE_REPS)
    got = root()
    root_plain_ms, want = once_ms(
        lambda: kf.kde_pick_plain(key, None, p1["data_p"], p1["data_x"], lm1,
                                  1.0, m),
        lambda: kf.kde_pick_plain(key, None, p1["data_p"], p1["data_x"], lm1,
                                  1.0, r))
    held_pick(p1["data_p"], lm1, 1.0, None)(got, want)
    del got, want
    root_bound = bound(kde_cost("pick", m, n1, 1, 0)[:4])
    out["root_pick"] = {"ms": root_ms, "plain_ms": root_plain_ms,
                        "bound_ms": root_bound[0], "bound_by": root_bound[1]}
    out["same_pick_share"] = {k: v[0] for k, v in agreement.items()}
    log("kernel_main_shape", kernel="vbn_kde_pick", case="root (Dp=0)", M=m,
        ms=root_ms, plain_ms=root_plain_ms, bound_ms=root_bound[0],
        bound_by=root_bound[1], agreement=agreement)
    return rows


def serve_kde(vbn_cls, defaults):
    """Phases 15-19 (the KDE slice); returns the KDE kernels' rows of the
    kernel line."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    errs = check_kde_kernels(dev)
    log("kde_kernel_check_done", max_abs_err=errs, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    flag = fit_kde(vbn_cls, defaults, [("x0", "x2"), ("x1", "x2")], flagship_data())
    gbn, gauss, queries, qd = gauss8_kde(vbn_cls, defaults)
    wide = fit_kde(vbn_cls, defaults, [("z", "y"), ("t", "y")], wide_data())
    torch.cuda.synchronize()
    log("kde_fit", seconds=time.perf_counter() - t0, max_points=KDE_POINTS,
        bandwidths={k: [c.bandwidth, c.parent_bandwidth]
                    for k, c in flag.nodes.items()})

    launches = {}
    KEPT["kde_flag"] = flag
    serve_kde_main_path(flag, launches)
    serve_kde_dynamic(gbn, gauss, queries, qd, launches)
    wide_args, wide_err = serve_kde_wide(wide, launches)
    errs["kde_cond_wide"] = max(errs["kde_cond_wide"], wide_err)
    log("kde_launches", total=launches)
    rows = time_kde_kernels(flag, wide_args, launches, errs)

    w1, w2, _ = kde_flagship_queries()
    out = {}
    for tag, q in (("w1_kde_flagship_lw", w1), ("w2_kde_flagship_diag", w2)):
        flag.set_inference_method("likelihood_weighting", n_samples=S_KDE)
        out[tag] = dynamic_qps(lambda: flag.infer_posterior_moments([q]), B_KDE)
    out["w3_kde_gauss8_dyn"] = dynamic_qps(
        lambda: gauss.infer_posterior_moments(qd, pad_bucket=N_KDE_DYN), N_KDE_DYN)
    q4 = w4_query()
    out["w4_kde_wide"] = dynamic_qps(
        lambda: wide.infer_posterior_moments([q4]), B_KDE)
    log("end_to_end_kde", **{f"{k}_qps": v[0] for k, v in out.items()},
        **{f"{k}_window_qps": v[1] for k, v in out.items()},
        S={"w1": S_KDE, "w2": S_KDE, "w3": S_KDE_DYN, "w4": S_KDE_DYN})
    for tag, q in (("W1 kde_flagship_lw", w1), ("W2 kde_flagship_diag", w2)):
        log("serve_profile", workload=tag, **profile_batch(
            lambda: flag.infer_posterior_moments([q]),
            ("kde_pick_", "kde_direct_kernel")))
    log("serve_profile", workload="W3 kde_gauss8_dyn", **profile_batch(
        lambda: gauss.infer_posterior_moments(qd, pad_bucket=N_KDE_DYN),
        ("kde_pick_", "kde_direct_kernel")))
    log("serve_profile", workload="W4 kde_wide", **profile_batch(
        lambda: wide.infer_posterior_moments([q4]),
        ("kde_pick_", "kde_wide_kernel", "kde_wide_prep", "kde_wide_mean")))
    return rows


# ---------------------------------------------------------------------------
# The exact engines: categorical_exact and gaussian_exact (no hand kernel)
# ---------------------------------------------------------------------------


def exact_rows(qs, pmf, spans, fit, order=None):
    """Max abs error of each served pmf row (normalized) against variable
    elimination on ``fit``."""
    from benchmarking.exact import exact_posterior

    err = 0.0
    for (lo, hi, _t), (t, ev) in zip(spans, qs):
        gt = np.asarray(exact_posterior(fit, t, ev, elim_order=order))
        rows = pmf[lo:hi, : gt.size].astype(np.float64)
        rows = rows / rows.sum(axis=1, keepdims=True)
        err = max(err, float(np.abs(rows - gt[None]).max()))
    return err


def serve_exact(vbn_cls, defaults, bn, asia_vbn, lg_vbn):
    """Phase exact_main_path: categorical_exact on asia (B=1024,
    enumeration) and on 96 queries each of insurance and alarm (junction
    tree), gaussian_exact on the flagship (B=1024) and on gauss107's 96
    queries (closed-form conditioning), through the public entry points on
    the card; launch counters reset just before each and read just after
    (the engines launch no hand kernel); pmf rows within 1e-5 of variable
    elimination on the fitted CPTs (floored at 1e-12, as the engines floor
    them), moments within 1e-4 of the posterior std of the fitted network's
    float64 closed form; queries/s (best of 3 windows), peak memory and a
    profiled batch of each. Float32 matmuls at full precision (no TF32)."""
    import torch
    from benchmarking.exact import min_fill_order
    from benchmarking.gaussian_bn import gaussian_ground_truth, random_gaussian
    from benchmarking.midsize import alarm, insurance
    from benchmarking.query_gen import generate_inference_queries

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}

    def served(tag, vbn, serve, b, check):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        rows, spans = serve()
        launches = read_launches({})
        mem = torch.cuda.max_memory_allocated()
        if not np.isfinite(rows).all():
            raise AssertionError(f"{tag}: rows not finite")
        acc = check(rows, spans)
        qps, windows = dynamic_qps(serve, b)
        log("exact_main_path", workload=tag, method=vbn._inference_config["name"],
            rows=list(rows.shape), launches=launches,
            path=vbn._last_summary_path, fallback=vbn._inference._last_fallback,
            max_memory_allocated_bytes=mem, qps=qps, window_qps=windows, **acc)
        log("serve_profile", workload=f"exact {tag}", **profile_batch(serve, ()))
        if vbn._last_summary_path != "fused" or vbn._inference._last_fallback:
            raise AssertionError(f"{tag}: not served by the exact engine")
        out[tag] = qps

    # categorical_exact: asia by enumeration, insurance and alarm by the
    # junction tree
    asia_vbn.set_inference_method("categorical_exact")
    qa = asia_query(B_MAIN)
    ev = qa["evidence"]
    asia_qs = [("dysp", {"smoke": int(ev["smoke"][r, 0]),
                         "asia": int(ev["asia"][r, 0])}) for r in range(B_MAIN)]
    asia_fit = fitted_discrete_bn(bn, asia_vbn, floor=1e-12)

    def asia_check(rows, spans):
        spans1 = [(r, r + 1, spans[0][2]) for r in range(B_MAIN)]
        err = exact_rows(asia_qs, rows, spans1, asia_fit)
        if err > 1e-5:
            raise AssertionError(f"asia exact pmf off by {err}")
        return {"pmf_max_abs_err": err}

    served("asia_b1024", asia_vbn,
           lambda: asia_vbn.infer_posterior_pmf([qa], n_classes=2), B_MAIN,
           asia_check)
    for net in (insurance, alarm):
        nbn = net(0)
        vbn = fit_discrete(vbn_cls, defaults, nbn)
        vbn.set_inference_method("categorical_exact")
        gen = generate_inference_queries(nbn, N_DYN, seed=0)
        qs = [(q.target, q.evidence) for q in gen]
        served_qs = [as_query(t, e) for t, e in qs]
        k = max(nbn.card(n) for n in nbn.nodes)
        fit = fitted_discrete_bn(nbn, vbn, floor=1e-12)

        def check(rows, spans, qs=qs, fit=fit):
            err = exact_rows(qs, rows, spans, fit, min_fill_order(fit))
            if err > 1e-5:
                raise AssertionError(f"{fit.name} exact pmf off by {err}")
            return {"pmf_max_abs_err": err, "queries": len(qs)}

        served(f"{nbn.name}_96", vbn,
               lambda vbn=vbn, q=served_qs, k=k: vbn.infer_posterior_pmf(
                   q, n_classes=k, pad_bucket=N_DYN), N_DYN, check)
        if not vbn._inference._jtree_cache:
            raise AssertionError(f"{nbn.name}: no junction tree was built")

    # gaussian_exact: the flagship and gauss107, closed-form conditioning
    lg_vbn.set_inference_method("gaussian_exact")
    ql = flagship_query(B_MAIN)
    p = lg_vbn.params["x2"]
    w = p["weight"][:, 0].double().cpu().numpy()
    sigma = float(np.sqrt(max(float(p["var"][0]),
                              lg_vbn.nodes["x2"].min_scale ** 2)))
    mean_cf = (ql["evidence"]["x0"][:, 0] * w[0] + ql["evidence"]["x1"][:, 0]
               * w[1] + float(p["bias"][0]))

    def flag_check(rows, spans):
        err = {"dmean_over_std": float(np.abs(rows[:, 0] - mean_cf).max() / sigma),
               "dstd_over_std": float(np.abs(rows[:, 1] - sigma).max() / sigma)}
        if max(err.values()) > 1e-4:
            raise AssertionError(f"flagship exact moments off: {err}")
        return err

    served("flagship_b1024", lg_vbn,
           lambda: lg_vbn.infer_posterior_moments([ql]), B_MAIN, flag_check)
    gbn = random_gaussian(107, seed=0)
    gvbn = fit_gaussian(vbn_cls, defaults, gbn)
    gvbn.set_inference_method("gaussian_exact")
    gqs = gauss_queries(gbn)
    truth = gaussian_ground_truth(fitted_gaussian_bn(gvbn), [
        types.SimpleNamespace(query_id=str(i), target=t, evidence=ev, do={})
        for i, (t, ev) in enumerate(gqs)])
    ref = np.array([[r["mean"], r["std"]] for r in truth])

    def gauss_check(rows, spans):
        got = rows[[lo for lo, _hi, _t in spans]].astype(np.float64)
        err = {"dmean_over_std": float(np.max(np.abs(got[:, 0] - ref[:, 0])
                                              / ref[:, 1])),
               "dstd_over_std": float(np.max(np.abs(got[:, 1] - ref[:, 1])
                                             / ref[:, 1]))}
        if max(err.values()) > 1e-4:
            raise AssertionError(f"gauss107 exact moments off: {err}")
        return err

    served("gauss107_96", gvbn,
           lambda: gvbn.infer_posterior_moments(
               [as_query(t, ev) for t, ev in gqs], pad_bucket=N_DYN), N_DYN,
           gauss_check)
    log("end_to_end_exact", **{f"{k}_qps": v for k, v in out.items()})
    asia_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    lg_vbn.set_inference_method("monte_carlo_marginalization", n_samples=S_MAIN)


# ---------------------------------------------------------------------------
# The neural CPD slice: gaussian_nn, mdn, rff_gaussian, softmax_nn and
# categorical_embedded_softmax (MLP products in torch, no hand kernel of
# their own; RIS over them launches the resampling kernels)
# ---------------------------------------------------------------------------

B_NN = 8
S_NN_IS, S_NN_RIS = 1 << 18, 1 << 20  # (a): tpu_study.py's IS depth; RIS
S_NN_DYN = 1 << 16  # (b): W3's depth
NN_ROWS = 1 << 16  # card-vs-CPU rows per family
# tpu_study.py:137 (configurations 2 and 3)
STUDY_FIT = {"epochs": 30, "batch_size": 1024, "lr": 1e-2, "weight_decay": 0.0}
# presets.py vbn_gnn_lw_dyn / vbn_mdn_lw_dyn
DYN_FIT = {"epochs": 60, "batch_size": 512, "lr": 3e-3}
# presets.py _EMB_FIT (vbn_emb_lw)
EMB_FIT = {"epochs": 200, "batch_size": 512, "lr": 5e-3, "weight_decay": 1e-3}


def timed_fit(tag, vbn, data):
    """Fit on the card; logs seconds per node and per optimizer step (the
    steps summed over the nodes' optimizer states)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vbn.fit(data)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = sum(int(p["opt"]["step"]) for p in vbn.params.values()
                if p.get("opt") is not None)
    rec = {"fit_s": secs, "nodes": len(vbn.nodes),
           "fit_s_per_node": secs / len(vbn.nodes), "optimizer_steps": steps,
           "fit_ms_per_step": 1e3 * secs / steps if steps else None}
    log("neural_fit", workload=tag, **rec)
    return rec


def launches_per_step(tag, cpd, parents, x, fit_kw):
    """Device kernels an optimizer step launches: a profiled fit of 3
    epochs less one of 1 epoch, over the steps between them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = x.shape[0]
    n_batches = -(-n // min(int(fit_kw["batch_size"]), n))
    counts = []
    for epochs in (1, 3):
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = cpd.init(torch.device("cuda"), gen=gen)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cpd.fit(params, parents, x, device=torch.device("cuda"), gen=gen,
                    **dict(fit_kw, epochs=epochs))
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    per = (counts[1] - counts[0]) / (2 * n_batches)
    log("neural_launches_per_step", workload=tag, cpd=cpd.registry_key,
        device_events_1_epoch=counts[0], device_events_3_epochs=counts[1],
        steps_between=2 * n_batches, launches_per_step=per)
    return per


def params_to(params, fn):
    from vectorizedbayesiannetwork_torch.models._optim import tree_map

    return tree_map(fn, params)


def nn_rows(data, parents, node, noise=0.0):
    """NN_ROWS fixed (parents [NN_ROWS, Din], x [NN_ROWS, 1]) rows on the
    card, drawn with replacement from a fit's data, the parents jittered by
    ``noise`` times a standard normal: card-vs-CPU inputs."""
    import torch

    g = np.random.default_rng(4)
    idx = g.integers(0, len(data[node]), NN_ROWS)
    par = np.stack([np.asarray(data[p], np.float32).reshape(-1)
                    for p in parents], 1)[idx]
    par = (par + noise * g.standard_normal(par.shape)).astype(np.float32)
    x = np.asarray(data[node], np.float32).reshape(-1, 1)[idx]
    return torch.as_tensor(par, device="cuda"), torch.as_tensor(x, device="cuda")


def card_vs_cpu(tag, cpd, params, parents, x):
    """The same params on the card and on the CPU over the same rows: each
    protocol method and the log-density in float32 within 1e-5 of its
    scale; for the MLP families, ``compute_dtype="bfloat16"`` on both
    (``torch.mm(..., out_dtype=torch.float32)`` on the card, bf16-rounded
    inputs multiplied in float32 on the CPU) within the JAX package's bf16
    tolerance (rtol 0.05, atol 0.15: tests/test_compute_dtype.py:70-73),
    and bf16 against float32 logged."""
    import copy

    import torch

    def methods(c, prm, par, xx):
        out = {"log_prob": c._log_prob_flat(prm, xx, par)}
        if hasattr(c, "categorical_probs"):
            out["categorical_probs"] = c.categorical_probs(prm, par)
        if hasattr(c, "mixture_params"):
            out.update(zip(("logits", "loc", "scale"),
                           c.mixture_params(prm, par)))
        if hasattr(c, "conditional_params"):
            out.update(zip(("cond_loc", "cond_scale"),
                           c.conditional_params(prm, par)))
        return out

    cpu_params = params_to(params, lambda t: t.cpu())
    with torch.no_grad():
        card = methods(cpd, params, parents, x)
        cpu = methods(cpd, cpu_params, parents.cpu(), x.cpu())
        errs = {}
        for k, want in cpu.items():
            got = card[k].cpu()
            errs[k] = float((got - want).abs().max()
                            / max(float(want.abs().max()), 1e-30))
        rec = {"rows": int(x.shape[0]), "rel_err": errs}
        if hasattr(cpd, "compute_dtype"):
            bf = copy.copy(cpd)
            bf.compute_dtype = "bfloat16"
            lp16 = bf._log_prob_flat(params, x, parents).cpu()
            cpu16 = bf._log_prob_flat(cpu_params, x.cpu(), parents.cpu())
            rec["bf16_card_vs_cpu_max_abs"] = float((lp16 - cpu16).abs().max())
            rec["bf16_vs_float32_max_abs"] = float(
                (lp16 - cpu["log_prob"]).abs().max())
            torch.testing.assert_close(lp16, cpu16, rtol=0.05, atol=0.15)
    log("neural_card_vs_cpu", workload=tag, cpd=cpd.registry_key, **rec,
        limit=1e-5)
    bad = {k: v for k, v in errs.items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"{tag}: card vs CPU past 1e-5: {bad}")


def check_bf16_product(dev):
    """The bf16 path's product on the card: bf16 inputs through
    ``torch.mm(..., out_dtype=torch.float32)``, held against the same bf16
    inputs multiplied in float64 (a float32 sum: ~1e-6 of the scale; a
    bf16-rounded output would be ~1e-3 off)."""
    import torch

    from vectorizedbayesiannetwork_torch.models import _mlp

    g = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn((NN_ROWS, 64), generator=g, device=dev)
    w = torch.randn((64, 64), generator=g, device=dev)
    out = _mlp._bf16_product(h, w)
    ref = h.bfloat16().double() @ w.bfloat16().double()
    scale = float(ref.abs().max())
    err = float((out.double() - ref).abs().max()) / scale
    rounded = float(((h.bfloat16() @ w.bfloat16()).double() - ref).abs().max()
                    ) / scale
    log("neural_bf16_product", dtype=str(out.dtype), rel_err=err,
        bf16_output_rel_err=rounded, torch_version=torch.__version__)
    if out.dtype != torch.float32 or not err < 1e-5 < rounded:
        raise AssertionError(f"bf16 product not float32-out: {err}, {rounded}")


def nn_flagship_reference(vbn, x2_vals, n_grid=1201, half=6.0):
    """(mean, std) of x0 | x2 = v for each v, in float64 on a 2-D grid over
    (x0, x1) of the fitted model's own densities p(x0) p(x1) p(x2 | x0,
    x1): each root's grid its fitted loc +- ``half`` of its scale."""
    import torch

    from vectorizedbayesiannetwork_torch.ops.gauss import LOG_2PI

    p64 = {n: params_to(vbn.params[n], lambda t: t.double()) for n in vbn.nodes}
    grids, logps = [], []
    for node in ("x0", "x1"):
        loc, scale = vbn.nodes[node].conditional_params(p64[node], None)
        loc, scale = float(loc.reshape(-1)[0]), float(scale.reshape(-1)[0])
        gr = loc + scale * torch.linspace(-half, half, n_grid,
                                          dtype=torch.float64, device=vbn.device)
        z = (gr - loc) / scale
        grids.append(gr)
        logps.append(-0.5 * (z * z + LOG_2PI) - np.log(scale))
    g0, g1 = grids
    pts = torch.stack(torch.meshgrid(g0, g1, indexing="ij"), -1).reshape(-1, 2)
    mdn = vbn.nodes["x2"]
    logits, loc, scale = mdn.mixture_params(p64["x2"], pts)
    out = []
    for v in x2_vals:
        x = torch.full((pts.shape[0], 1), float(v), dtype=torch.float64,
                       device=vbn.device)
        lp2 = mdn._mixture_log_prob(logits, loc, scale, x).reshape(n_grid, n_grid)
        joint = logps[0][:, None] + logps[1][None, :] + lp2
        post = torch.logsumexp(joint, dim=1)
        w = torch.softmax(post, dim=0)
        mean = float((w * g0).sum())
        out.append((mean, float(torch.sqrt((w * (g0 - mean) ** 2).sum()))))
    return np.array(out)


def served_moments(vbn, q):
    w, samples = vbn.infer_posterior(q)
    st = vbn._posterior_stats(w, samples.float())
    return np.stack([st["mean"][:, 0].double().cpu().numpy(),
                     st["std"][:, 0].double().cpu().numpy()], 1)


def neural_flagship(vbn_cls, defaults, fits):
    """(a) tpu_study.py:135-152: gaussian_nn x0, x1 and mdn x2 (3
    components) fitted on the flagship's rows; x0 | x2 = linspace(-1, 1, 8)
    by IS at S=2^18 and RIS at S=2^20, each (mean, std) within 0.05 of the
    posterior std of a float64 grid reference of the fitted model. RIS
    launches vbn_cumsum and vbn_srg once each; returns those launches."""
    import torch

    vbn = vbn_cls([("x0", "x2"), ("x1", "x2")], seed=0)
    conf = {k: {**defaults.cpd("gaussian_nn"), "fit": dict(STUDY_FIT)}
            for k in ("x0", "x1")}
    conf["x2"] = {**defaults.cpd("mdn"), "n_components": 3,
                  "fit": dict(STUDY_FIT)}
    vbn.set_learning_method("node_wise", nodes_cpds=conf)
    data = flagship_data()
    fits["a_flagship_gnn_mdn"] = timed_fit("a flagship gaussian_nn+mdn", vbn, data)
    q = flagship_diag_query(B_NN)
    ref = nn_flagship_reference(vbn, q["evidence"]["x2"][:, 0])
    total = {}
    rows = {}
    for method, s, kw, expect in (
            ("importance_sampling", S_NN_IS, {}, {"uniforms": SOME}),
            ("resampled_importance_sampling", S_NN_RIS,
             {"ess_threshold": 0.5, "resample_method": "systematic"},
             {"cumsum": 1, "srg": 1, "uniforms": SOME})):
        vbn.set_inference_method(method, n_samples=s, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        got = served_moments(vbn, q)
        launches = read_launches(expect)
        mem = torch.cuda.max_memory_allocated()
        dmean = float(np.max(np.abs(got[:, 0] - ref[:, 0]) / ref[:, 1]))
        dstd = float(np.max(np.abs(got[:, 1] - ref[:, 1]) / ref[:, 1]))
        qps, windows, serve = method_qps(vbn, q, B_NN)
        rec = {"S": s, "B": B_NN, "launches": launches,
               "dmean_over_std": dmean, "dstd_over_std": dstd, "limit": 0.05,
               "queries_per_s": qps, "window_qps": windows,
               "max_memory_allocated_bytes": mem}
        if method == "resampled_importance_sampling":
            rec["resampled"] = bool(vbn._inference._last_resampled)
            if not rec["resampled"]:
                raise AssertionError("RIS did not resample the neural flagship")
        log("neural_main_path", workload=f"a flagship {method}", **rec)
        if not (dmean <= 0.05 and dstd <= 0.05):
            raise AssertionError(f"(a) {method} off the grid reference: "
                                 f"{dmean}, {dstd}")
        if method == "importance_sampling":
            log("serve_profile", workload="a flagship gaussian_nn+mdn IS",
                **profile_batch(serve, (), top=6))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        rows[method] = got.tolist()
    log("neural_flagship_reference", grid_moments=ref.tolist(), served=rows)
    KEPT["a_flagship"] = (vbn, q, ref)
    card_vs_cpu("a mdn x2", vbn.nodes["x2"], vbn.params["x2"],
                *nn_rows(data, ["x0", "x1"], "x2", noise=0.1))
    launches_per_step("a mdn x2", vbn.nodes["x2"],
                      np.stack([data["x0"], data["x1"]], 1), data["x2"],
                      STUDY_FIT)
    return total


def neural_gauss8(vbn_cls, defaults, fits):
    """(b) W3's network and queries with gaussian_nn (vbn_gnn_lw_dyn),
    mdn (5 components, vbn_mdn_lw_dyn) and rff_gaussian (256 features):
    each the 96 queries by LW dynamic_masks=True at S=2^16, KL to the true
    posterior; gaussian_exact's answers on the gaussian_nn fit."""
    import torch
    from benchmarking.gaussian_bn import (
        generate_gaussian_inference_queries,
        random_gaussian,
    )

    gbn = random_gaussian(8, seed=0)
    data = gbn.sample(4096, seed=1)
    queries = generate_gaussian_inference_queries(gbn, n_queries=N_DYN, seed=2)
    qd = [{"target": q.target,
           "evidence": {k: np.array([[float(v)]], np.float32)
                        for k, v in q.evidence.items()}} for q in queries]
    parents = {n: gbn.parents[n] for n in gbn.nodes}
    confs = {
        "gaussian_nn": {**defaults.cpd("gaussian_nn"), "fit": dict(DYN_FIT)},
        "mdn": {**defaults.cpd("mdn"), "n_components": 5, "fit": dict(DYN_FIT)},
        "rff_gaussian": {**defaults.cpd("rff_gaussian"), "n_features": 256},
    }
    child = next(n for n in gbn.nodes if gbn.parents[n])
    # the dynamic sweep runs each node's draw and log-density forward once a
    # call: vbn_gauss_mlp launches twice a gaussian_nn node with parents
    mlp = 2 * sum(1 for n in gbn.nodes if gbn.parents[n])
    for fam, conf in confs.items():
        vbn = vbn_cls(parents, seed=0)
        vbn.set_learning_method("node_wise",
                                nodes_cpds={n: dict(conf) for n in gbn.nodes})
        fits[f"b_gauss8_{fam}"] = timed_fit(f"b gauss8 {fam}", vbn, data)
        vbn.set_inference_method("likelihood_weighting", n_samples=S_NN_DYN,
                                 dynamic_masks=True)
        serve = lambda: vbn.infer_posterior_moments(qd, pad_bucket=N_DYN)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        mom, spans = serve()
        launches = read_launches(
            {"uniforms": SOME, "gauss_mlp": mlp if fam == "gaussian_nn" else 0})
        mem = torch.cuda.max_memory_allocated()
        if mom.shape != (N_DYN, 2) or not np.isfinite(mom).all():
            raise AssertionError(f"(b) {fam} moments rows bad")
        qps, windows = dynamic_qps(serve)
        log("neural_main_path", workload=f"b gauss8 {fam} LW dynamic",
            queries=N_DYN, S=S_NN_DYN, launches=launches,
            summary_path=vbn._last_summary_path, queries_per_s=qps,
            window_qps=windows, max_memory_allocated_bytes=mem,
            **gauss_kl(gbn, queries, mom, spans))
        card_vs_cpu(f"b {fam} {child}", vbn.nodes[child], vbn.params[child],
                    *nn_rows(data, gbn.parents[child], child, noise=0.1))
        log("serve_profile", workload=f"b gauss8 {fam} LW dynamic",
            **profile_batch(serve, (), top=6))
        if fam != "gaussian_nn":
            continue
        KEPT["b_gaussian_nn"] = (vbn, qd)
        KEPT["b_gauss_mlp_launches"] = launches["gauss_mlp"]
        launches_per_step(f"b gaussian_nn {child}", vbn.nodes[child],
                          np.stack([data[p] for p in gbn.parents[child]], 1),
                          data[child], DYN_FIT)
        vbn.set_inference_method("gaussian_exact")
        mom, spans = vbn.infer_posterior_moments(qd)
        grid = sum(1 for q in queries if q.target not in q.evidence and all(
            p in q.evidence for p in gbn.parents[q.target]))
        log("neural_main_path", workload="b gauss8 gaussian_nn gaussian_exact",
            queries=N_DYN, grid_served=grid, fallback="likelihood_weighting",
            summary_path=vbn._last_summary_path,
            **gauss_kl(gbn, queries, mom, spans))


def cpt_kl(vbn, bn):
    """Mean over nodes of the mean KL of each true CPT row to the fitted
    conditional (tests/test_emb_accuracy.py's measure)."""
    kls = []
    for node in bn.nodes:
        cards = [bn.card(p) for p in bn.parents[node]]
        rows = (np.array(np.meshgrid(*[np.arange(c) for c in cards],
                                     indexing="ij")).reshape(len(cards), -1)
                .T.astype(np.float32) if cards else None)
        probs = vbn.cpd(node).conditional(rows)["probs"].cpu().numpy()
        true = np.asarray(bn.cpts[node]).reshape(-1, bn.card(node))
        probs = probs.reshape(true.shape)
        kl = np.sum(true * (np.log(np.maximum(true, 1e-12))
                            - np.log(np.maximum(probs, 1e-12))), axis=-1)
        kls.append(float(np.mean(kl)))
    return float(np.mean(kls))


def pmf_against_exact(tag, vbn, q, k):
    """LW pmf rows (B_NN, S=2^20, counters read) against categorical_exact
    on the same fitted model: max abs err <= 5e-3; queries/s of LW."""
    import torch

    vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    serve = lambda: vbn.infer_posterior_pmf([q], n_classes=k)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    pmf, _ = serve()
    launches = read_launches({"uniforms": SOME})
    mem = torch.cuda.max_memory_allocated()
    path = vbn._last_summary_path
    qps, windows = dynamic_qps(serve, B_NN)
    profile = profile_batch(serve, (), top=6)
    vbn.set_inference_method("categorical_exact")
    ex, _ = vbn.infer_posterior_pmf([q], n_classes=k)
    if vbn._inference._last_fallback:
        raise AssertionError(f"{tag}: categorical_exact fell back")
    norm = lambda r: r / r.sum(axis=1, keepdims=True)  # noqa: E731
    err = float(np.abs(norm(pmf.astype(np.float64))
                       - norm(ex.astype(np.float64))).max())
    log("neural_main_path", workload=f"{tag} LW pmf", B=B_NN, S=S_MAIN,
        launches=launches, summary_path=path,
        max_abs_err_vs_categorical_exact=err, limit=5e-3, queries_per_s=qps,
        window_qps=windows, max_memory_allocated_bytes=mem)
    log("serve_profile", workload=f"{tag} LW pmf", **profile)
    if not err <= 5e-3:
        raise AssertionError(f"{tag}: LW pmf off categorical_exact by {err}")


def neural_discrete(vbn_cls, defaults, bn, asia_vbn, fits):
    """(c) asia with categorical_embedded_softmax (vbn_emb_lw:
    embedding_dim 8, hidden [64, 64], _EMB_FIT) on asia's 4096 rows: mean
    KL to the true CPTs within 2x categorical_table's + 1e-3 (the table fit
    on the same rows); LW P(dysp | smoke, asia) against categorical_exact.
    (d) the discretized flagship with softmax_nn (8 classes,
    tpu_study.py:154-170): LW pmf of x2 | x0 against categorical_exact."""
    import torch
    from benchmarking.data_gen import generate_dataset

    data = {k: np.asarray(v, np.float32).reshape(-1, 1)
            for k, v in generate_dataset(bn, 4096, seed=0).items()}
    emb = vbn_cls({n: bn.parents[n] for n in bn.nodes}, seed=0)
    emb.set_learning_method("node_wise", nodes_cpds={
        n: {**defaults.cpd("categorical_embedded_softmax"), "embedding_dim": 8,
            "fit": dict(EMB_FIT)} for n in bn.nodes})
    fits["c_asia_emb"] = timed_fit("c asia categorical_embedded_softmax", emb,
                                   data)
    kl_emb, kl_tab = cpt_kl(emb, bn), cpt_kl(asia_vbn, bn)
    log("neural_fit_accuracy", workload="c asia categorical_embedded_softmax",
        kl_emb=kl_emb, kl_table=kl_tab, limit=2.0 * kl_tab + 1e-3)
    if not kl_emb <= 2.0 * kl_tab + 1e-3:
        raise AssertionError(f"(c) embedded KL {kl_emb} vs table {kl_tab}")
    pmf_against_exact("c asia categorical_embedded_softmax", emb,
                      asia_query(B_NN), 2)
    KEPT["c_emb"] = emb
    node = "dysp"
    card_vs_cpu(f"c {node}", emb.nodes[node], emb.params[node],
                *nn_rows(data, bn.parents[node], node))
    launches_per_step(f"c categorical_embedded_softmax {node}", emb.nodes[node],
                      np.concatenate([data[p] for p in bn.parents[node]], 1),
                      data[node], EMB_FIT)

    flag = {k: np.rint(np.clip(v * 2 + 4, 0, 7)).astype(np.float32)
            for k, v in flagship_data().items()}
    sm = vbn_cls([("x0", "x2"), ("x1", "x2")], seed=0)
    sm.set_learning_method("node_wise", nodes_cpds={
        k: {**defaults.cpd("softmax_nn"), "n_classes": 8,
            "fit": dict(STUDY_FIT)} for k in flag})
    fits["d_flagship_softmax"] = timed_fit("d discretized flagship softmax_nn",
                                           sm, flag)
    q = {"target": "x2", "evidence": {
        "x0": np.arange(B_NN, dtype=np.float32).reshape(B_NN, 1)}}
    pmf_against_exact("d flagship softmax_nn", sm, q, 8)
    card_vs_cpu("d x2", sm.nodes["x2"], sm.params["x2"],
                *nn_rows(flag, ["x0", "x1"], "x2"))
    launches_per_step("d softmax_nn x2", sm.nodes["x2"],
                      np.stack([flag["x0"], flag["x1"]], 1), flag["x2"],
                      STUDY_FIT)
    return sm


def serve_neural(vbn_cls, defaults, bn, asia_vbn):
    """Phase neural_main_path: paths (a)-(d) above, each fit timed, each
    served batch with the counters reset just before and read just after,
    card against CPU on every family; returns the resampling kernels'
    launches (RIS in (a)) and (d)'s fitted softmax_nn network."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    check_bf16_product(torch.device("cuda"))
    fits = {}
    launches = neural_flagship(vbn_cls, defaults, fits)
    neural_gauss8(vbn_cls, defaults, fits)
    sm = neural_discrete(vbn_cls, defaults, bn, asia_vbn, fits)
    steps = sum(f["optimizer_steps"] for f in fits.values())
    fit_s = sum(f["fit_s"] for f in fits.values())
    log("neural_done", seconds=time.perf_counter() - t0, fit_s=fit_s,
        optimizer_steps=steps, launches=launches)
    return launches, sm


# ---------------------------------------------------------------------------
# Sampling (ancestral, Gibbs, HMC, NUTS) and the online update policies
# ---------------------------------------------------------------------------

S1_DRAWS = 1 << 20  # tpu_study.py:162-177: softmax_nn ancestral
S2 = {"n_samples": 256, "burn_in": 20, "n_chains": 64}  # tpu_study.py:179-192
S3 = {"n_samples": 1024, "burn_in": 50, "n_steps": 5}  # gibbs_micro.py:22-50
S4 = {"n_samples": 400, "burn_in": 50, "step_size": 0.2, "n_chains": 8,
      "n_leapfrog": 8}  # tests/test_sampling.py:71-150
S4_NUTS_DEPTH = 6  # NUTS's max_tree_depth here: at most 63 leapfrogs a step
S4_KDE = {"n_samples": 256, "burn_in": 50, "step_size": 0.2, "n_chains": 64,
          "n_leapfrog": 8}  # HMC over the KDE flagship at (s2)'s query
M_GRAD = 1 << 14  # rows of the KDE gradient check
U1_REPS = 8  # timed update calls (r2_measure.py:67-79)


class keyed_route:
    """Hide ``_noise_spec`` from the given CPD classes, so Gibbs draws its
    noise step by step (the route the JAX package's test forces by
    ``monkeypatch.delattr``)."""

    def __init__(self, *classes):
        self.classes = classes

    def __enter__(self):
        self.saved = [(c, c.__dict__["_noise_spec"]) for c in self.classes]
        for c, _ in self.saved:
            delattr(c, "_noise_spec")

    def __exit__(self, *exc):
        for c, fn in self.saved:
            c._noise_spec = fn


def timed(fn):
    """(fn()'s result, its seconds to a synchronized card, peak bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def batch_means_se(draws, chains, draw_major):
    """Per row: the standard error of the mean from the chains' means
    (``draws`` [B, n]; Gibbs lays a row out draw-major, HMC chain-major),
    or with one chain from 32 batches of consecutive draws."""
    b, n = draws.shape
    if chains == 1:
        groups = draws[:, : n - n % 32].reshape(b, 32, -1).mean(axis=2)
    elif draw_major:
        groups = draws.reshape(b, -1, chains).mean(axis=1)
    else:
        groups = draws.reshape(b, chains, -1).mean(axis=2)
    return groups.std(axis=1, ddof=1) / np.sqrt(groups.shape[1])


def hold_moments(tag, draws, want, se, *, limit_se=5.0, abs_limit=None,
                 hold_std=True):
    """Means within ``limit_se`` standard errors of ``want`` (or within
    ``abs_limit``); with ``hold_std``, stds within 15 % plus ``limit_se``
    standard errors of the mean."""
    mean, std = draws.mean(axis=1), draws.std(axis=1)
    dmean = np.abs(mean - want[:, 0])
    dstd = np.abs(std - want[:, 1])
    lim = abs_limit if abs_limit is not None else limit_se * se
    ok = bool(np.all(dmean <= lim) and (
        not hold_std or np.all(dstd <= 0.15 * want[:, 1] + limit_se * se)))
    rec = {"mean": mean.tolist(), "std": std.tolist(),
           "reference": want.tolist(), "se": se.tolist(),
           "max_dmean_over_se": float(np.max(dmean / se)),
           "max_dstd_over_std": float(np.max(dstd / want[:, 1])),
           "mean_limit": np.atleast_1d(lim).tolist()}
    if not ok:
        raise AssertionError(f"{tag}: draws off the reference: {rec}")
    return rec


def device_events_per_call(fn):
    """Device kernels (torch.profiler events) one call of ``fn`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def sampling_s1(sm):
    """(s1) ancestral over (d)'s softmax_nn network, x2 with no evidence,
    2^20 draws: the class histogram against categorical_exact's marginal
    by a merged chi-square z (limit 6)."""
    q = {"target": "x2", "evidence": {}}
    sm.set_sampling_method("ancestral")
    sm.sample(q, n_samples=1 << 10)
    reset_launches()
    draws, secs, mem = timed(lambda: sm.sample(q, n_samples=S1_DRAWS))
    launches = read_launches({"uniforms": SOME})
    sm.set_inference_method("categorical_exact")
    ex, _ = sm.infer_posterior_pmf([q], n_classes=8)
    probs = ex[0].astype(np.float64) / ex[0].sum()
    vals = draws[0, :, 0].cpu().numpy()
    counts = np.bincount(np.clip(np.rint(vals), 0, 7).astype(np.int64),
                         minlength=8)
    z = chi2_z_merged(counts.astype(np.float64), probs)
    log("sampling_main_path", workload="s1 softmax_nn ancestral", draws=S1_DRAWS,
        ms=1e3 * secs, draws_per_s=S1_DRAWS / secs, launches=launches,
        max_memory_allocated_bytes=mem, chi2_z=z, limit=6.0,
        frequencies=(counts / counts.sum()).tolist(), exact=probs.tolist(),
        on_class_values=bool(np.all(vals == np.rint(vals))))
    if not z <= 6.0 or not np.all(vals == np.rint(vals)):
        raise AssertionError(f"(s1) draws off categorical_exact: z={z}")


def sampling_s2(flag, ref_w2, total):
    """(s2) Gibbs over the KDE flagship, W2's query: the keyed route (KDE
    has no noise split): per step a pick for each latent node's candidates
    and its child's conditional for their scores."""
    _, w2, _ = kde_flagship_queries()
    flag.set_sampling_method("gibbs")
    flag.sample(w2, **dict(S2, n_samples=64, burn_in=2))
    steps = S2["burn_in"] + -(-S2["n_samples"] // S2["n_chains"])
    expect = {"kde_pick": 2 + 2 * steps, "kde_cond": 2 * steps,
              "uniforms": SOME}
    reset_launches()
    draws, secs, mem = timed(lambda: flag.sample(w2, **S2))
    launches = read_launches(expect)
    add_launches(total, launches, KDE_NAMES + ("uniforms",))
    d = draws[..., 0].cpu().numpy().astype(np.float64)
    se = batch_means_se(d, S2["n_chains"], draw_major=True)
    acc = hold_moments("(s2) Gibbs over KDE", d, ref_w2, se)
    prof = profile_batch(lambda: flag.sample(w2, **S2),
                         ("kde_pick_", "kde_direct_kernel"))
    n_draws = B_KDE * S2["n_samples"]
    log("sampling_main_path", workload="s2 KDE Gibbs", B=B_KDE, **S2,
        ms=1e3 * secs, draws_per_s=n_draws / secs, steps=steps,
        launches=launches, hoisted=flag._sampling._last_hoisted,
        max_memory_allocated_bytes=mem, **acc)
    log("serve_profile", workload="s2 KDE Gibbs", **prof)


def sampling_s3(vbn_cls, defaults, total):
    """(s3) Gibbs on the 3-node LG, x2 | x0 = 0.5, one chain: hoisted noise,
    then the keyed route; each mean against gaussian_exact within 5
    standard errors (32 batch means)."""
    from vectorizedbayesiannetwork_torch.models.linear_gaussian import (
        LinearGaussianCPD,
    )

    vbn = fit_flagship(vbn_cls, defaults)
    q = {"target": "x2", "evidence": {"x0": [[0.5]]}}
    vbn.set_inference_method("gaussian_exact")
    want, _ = vbn.infer_posterior_moments([q])
    vbn.set_sampling_method("gibbs")
    for route in ("hoisted", "keyed"):
        run = lambda: vbn.sample(q, **S3)  # noqa: E731
        if route == "keyed":
            with keyed_route(LinearGaussianCPD):
                vbn.sample(q, n_samples=8, burn_in=2)
                reset_launches()
                draws, secs, mem = timed(run)
        else:
            vbn.sample(q, n_samples=8, burn_in=2)
            reset_launches()
            draws, secs, mem = timed(run)
        launches = read_launches({"uniforms": SOME})
        add_launches(total, launches, ("uniforms",))
        if vbn._sampling._last_hoisted != (route == "hoisted"):
            raise AssertionError(f"(s3) took the wrong noise route: {route}")
        d = draws[..., 0].cpu().numpy().astype(np.float64)
        acc = hold_moments(f"(s3) Gibbs LG {route}", d, want,
                           batch_means_se(d, 1, draw_major=True))
        steps = S3["burn_in"] + S3["n_samples"] * S3["n_steps"]
        log("sampling_main_path", workload=f"s3 LG Gibbs {route}", **S3,
            ms=1e3 * secs, ms_per_step=1e3 * secs / steps, launches=launches,
            max_memory_allocated_bytes=mem, **acc)


def sampling_s4(vbn_cls, defaults, flag, ref_w2, total):
    """(s4) HMC and NUTS on the LG flagship, x0 | x2 = 0.5, against
    gaussian_exact (the JAX test's limits on the mean: 0.15, and 0.2
    adapting from a step of 5; NUTS's std within 15 %; HMC's std only
    logged: at this step and trajectory its leapfrog map turns the
    posterior's stiff direction by nearly half a period, so each chain
    swings about the mean with the amplitude it started with, in either
    package); HMC and NUTS over the KDE flagship at W2's query against its
    float64 reference (means within 5 standard errors of 64 chains' means;
    NUTS's stds within 15 % and 5 of them, HMC's logged, as on the LG); the
    KDE gradient on the card against autograd of the plain version."""
    import torch

    lg = fit_flagship(vbn_cls, defaults)
    q = {"target": "x0", "evidence": {"x2": [[0.5]]}}
    lg.set_inference_method("gaussian_exact")
    want, _ = lg.infer_posterior_moments([q])
    runs = (("hmc", dict(S4), 0.15),
            ("nuts", dict(S4, max_tree_depth=S4_NUTS_DEPTH), 0.15),
            ("nuts", dict(S4, max_tree_depth=S4_NUTS_DEPTH, step_size=5.0,
                          adapt_step_size=True), 0.2))
    for name, kw, limit in runs:
        lg.set_sampling_method(name)
        lg.sample(q, **dict(kw, n_samples=16, burn_in=2))
        reset_launches()
        draws, secs, mem = timed(lambda: lg.sample(q, **kw))
        launches = read_launches({"uniforms": SOME})
        add_launches(total, launches, ("uniforms",))
        transitions = kw["burn_in"] + -(-kw["n_samples"] // kw["n_chains"])
        leapfrogs = lg._sampling._leapfrogs
        d = draws[..., 0].cpu().numpy().astype(np.float64)
        acc = hold_moments(f"(s4) {name} LG", d, want,
                           batch_means_se(d, kw["n_chains"], draw_major=False),
                           abs_limit=limit, hold_std=name == "nuts")
        # a profiled call of 5 transitions: burn-in 4, one draw a chain
        events = device_events_per_call(
            lambda: lg.sample(q, **dict(kw, n_samples=kw["n_chains"],
                                        burn_in=4)))
        log("sampling_main_path", workload=f"s4 LG {name}",
            adapt=bool(kw.get("adapt_step_size")), ms=1e3 * secs,
            ms_per_transition=1e3 * secs / transitions,
            leapfrogs_per_transition=leapfrogs / transitions,
            device_kernels_per_transition=events / 5, launches=launches,
            max_memory_allocated_bytes=mem, **acc)

    _, w2, _ = kde_flagship_queries()
    nuts_kw = {k: v for k, v in S4_KDE.items() if k != "n_leapfrog"}
    for name, kw in (("hmc", S4_KDE),
                     ("nuts", dict(nuts_kw, max_tree_depth=S4_NUTS_DEPTH))):
        flag.set_sampling_method(name)
        flag.sample(w2, **dict(kw, n_samples=64, burn_in=2))
        transitions = kw["burn_in"] + -(-kw["n_samples"] // kw["n_chains"])
        reset_launches()
        draws, secs, mem = timed(lambda: flag.sample(w2, **kw))
        # a gradient evaluation a leapfrog, and one at each transition's
        # start; each evaluates x0's and x1's root density and x2's
        # conditional; the init sweep picks x0 and x1
        evals = transitions + flag._sampling._leapfrogs
        launches = read_launches({"kde_pick": 2, "kde_root": 2 * evals,
                                  "kde_cond": evals, "uniforms": SOME})
        add_launches(total, launches, KDE_NAMES + ("uniforms",))
        d = draws[..., 0].cpu().numpy().astype(np.float64)
        acc = hold_moments(f"(s4) {name} over KDE", d, ref_w2,
                           batch_means_se(d, kw["n_chains"], draw_major=False),
                           hold_std=name == "nuts")
        log("sampling_main_path", workload=f"s4 KDE {name}", B=B_KDE, **kw,
            ms=1e3 * secs, ms_per_transition=1e3 * secs / transitions,
            leapfrogs_per_transition=flag._sampling._leapfrogs / transitions,
            draws_per_s=B_KDE * kw["n_samples"] / secs,
            launches_per_transition={k: v / transitions
                                     for k, v in launches.items() if v},
            launches=launches, max_memory_allocated_bytes=mem, **acc)
        if name == "hmc":
            log("serve_profile", workload="s4 KDE HMC", **profile_batch(
                lambda: flag.sample(w2, **kw), ("kde_direct_kernel",)))
    check_kde_gradient(flag)
    torch.cuda.synchronize()


def check_kde_gradient(flag):
    """The KDE log-density's autograd.Function on the card, at the KDE
    flagship's x2 | x0, x1 support (N = 2048, W2's node) and at x0's root
    support, M_GRAD rows: its forward is the kernel (one launch), its
    backward within 1e-5 of the gradient's scale of ``torch.autograd`` of
    the plain version; the forward's and backward's ms at HMC's M."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import kde_fused as kf
    from vectorizedbayesiannetwork_torch.ops import kde_kernel as kk

    dev = flag.device
    g = torch.Generator(device=dev).manual_seed(7)
    for node, entry in (("x2", "kde_cond"), ("x0", "kde_root")):
        cpd, p = flag.nodes[node], flag.params[node]
        lm = cpd._log_mask(p)
        ys, ps = cpd._y_scale(), cpd._p_scale()
        dp = cpd.input_dim
        x = torch.randn((M_GRAD, 1), generator=g, device=dev)
        par = (torch.randn((M_GRAD, dp), generator=g, device=dev)
               if dp else None)
        w = torch.randn((M_GRAD,), generator=g, device=dev)
        args = (p["data_x"], p["data_p"], lm, ys, ps)

        def grads(fn, xx, pp):
            xx = xx.clone().requires_grad_(True)
            pp = pp.clone().requires_grad_(True) if pp is not None else None
            out = fn(xx, pp)
            return out.detach(), torch.autograd.grad(
                (out * w).sum(), [xx] + ([pp] if pp is not None else []))

        reset_launches()
        out, got = grads(lambda a, b: kk.kde_log_prob(a, b, *args), x, par)
        launches = read_launches({entry: 1})
        if dp:
            plain = lambda a, b: kf.kde_cond_plain(a, b, *args)  # noqa: E731
        else:
            plain = lambda a, b: (kf.kde_root_plain(a, args[0], lm, ys)  # noqa: E731
                                  - torch.log(torch.clamp(torch.exp(lm).sum(),
                                                          min=1.0)))
        ref_out, ref = grads(plain, x, par)
        fwd_err = float((out - ref_out).abs().max())
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, ref))
        m = B_KDE * S4_KDE["n_chains"]
        xs, ps_ = x[:m], (par[:m] if dp else None)
        fwd_ms = cuda_ms(lambda: kk.kde_log_prob(xs, ps_, *args), 5)

        def fwd_bwd():
            xx = xs.clone().requires_grad_(True)
            torch.autograd.grad(kk.kde_log_prob(xx, ps_, *args).sum(), xx)

        both_ms = cuda_ms(fwd_bwd, 5)
        log("kde_gradient_check", node=node, kernel=f"vbn_{entry}", M=M_GRAD,
            N=int(p["data_x"].shape[0]), launches=launches,
            forward_max_abs_err=fwd_err, grad_max_rel_err=rel, limit=1e-5,
            forward_ms_at_hmc_m=fwd_ms, forward_backward_ms_at_hmc_m=both_ms,
            hmc_m=m)
        if not (fwd_err <= 1e-4 and rel <= 1e-5):
            raise AssertionError(
                f"KDE gradient on the card off: {fwd_err}, {rel}")


def serve_sampling(vbn_cls, defaults, sm):
    """Phases s1-s4; returns the KDE kernels' launches of s2 and s4 and the
    ``vbn_uniforms`` launches of s2-s4 (the chains' draws)."""
    import torch

    t0 = time.perf_counter()
    sampling_s1(sm)
    flag = fit_kde(vbn_cls, defaults, [("x0", "x2"), ("x1", "x2")],
                   flagship_data())
    v = kde_flagship_queries()[1]["evidence"]["x2"][:, 0].astype(np.float64)
    ref_w2 = kde_reference(flag, "w2", v)
    total = {}
    sampling_s2(flag, ref_w2, total)
    sampling_s3(vbn_cls, defaults, total)
    sampling_s4(vbn_cls, defaults, flag, ref_w2, total)
    torch.cuda.synchronize()
    log("sampling_done", seconds=time.perf_counter() - t0, launches=total)
    return total


def update_workloads(vbn_cls, defaults):
    """r2_measure.py:83-101's four workloads (tag, dag, nodes_cpds, fit
    rows, update rows), plus KDE streaming_stats on the flagship at
    max_points 2048 (tpu_study.py:200-205's update of 1024 rows), fitted on
    4096 rows and updated on 1024 others (rows a KDE already holds would
    enter its support twice)."""
    g = np.random.default_rng(0)
    n = 8192
    x0, x1 = g.normal(size=n), g.normal(size=n)
    x2 = 0.6 * x0 - 0.3 * x1 + 0.1 * g.normal(size=n)
    df = {"x0": x0, "x1": x1, "x2": x2}
    head = lambda d, k: {c: v[:k] for c, v in d.items()}  # noqa: E731
    chain = [("x0", "x2"), ("x1", "x2")]
    nn_conf = defaults.cpd("gaussian_nn")
    a = g.integers(0, 8, size=n)
    b = (a + g.integers(0, 4, size=n)) % 8
    dfd = {"a": a.astype(np.float64), "b": b.astype(np.float64)}
    ct = dict(defaults.cpd("categorical_table"), n_classes=8)
    kde = dict(defaults.cpd("kde"), max_points=KDE_POINTS)
    return (
        ("lg_streaming_stats", chain,
         {k: defaults.cpd("linear_gaussian") for k in df}, df,
         "streaming_stats", head(df, 1024)),
        ("nn_online_sgd", chain, {k: dict(nn_conf) for k in df},
         head(df, 4096), "online_sgd", head(df, 1024)),
        ("nn_ema", chain, {k: dict(nn_conf) for k in df}, head(df, 4096),
         "ema", head(df, 1024)),
        ("ct_streaming_stats", [("a", "b")],
         {"a": ct, "b": dict(ct, parent_n_classes=[8])}, dfd,
         "streaming_stats", head(dfd, 1024)),
        ("kde_streaming_stats", chain, {k: dict(kde) for k in df},
         head(df, 4096), "streaming_stats",
         {c: v[4096:5120] for c, v in df.items()}),
    )


def flat_params(tree, prefix=""):
    import torch

    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_params(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_params(v, f"{prefix}#{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().double().numpy()
    return out


def update_card_vs_cpu(tag, vbn_cls, vbn, frame, policy, path):
    """One more update of the card's model and of its checkpoint loaded on
    the CPU, the neural ones on full batches (the minibatch order comes
    from each device's generator): closed forms within 1e-5 of scale
    (categorical counts exactly), neural within 1e-5 of scale (float32
    rounding); KDE's Gumbel top-k draws on each device's generator, so its
    support is held as a uniform subset (``max_points`` rows, each kept no
    more often than the pool holds it, the new rows' share within 5 sd of
    a hypergeometric draw) and the updated log-densities card against CPU
    within 1e-4."""
    import torch

    nodes_cpds = vbn._learning_config["nodes_cpds"]
    for conf in nodes_cpds.values():
        if conf["cpd"] in ("gaussian_nn", "mdn"):
            conf["update"] = dict(conf["update"], batch_size=1 << 20)
    vbn.save(path)
    cpu = vbn_cls.load(path, device="cpu")
    pool = {n: flat_params(vbn.params[n]) for n in vbn.nodes}
    vbn.update(frame, update_method=policy)
    cpu.update(frame, update_method=policy)
    rec = {"route": vbn._last_update_route}
    if tag.startswith("kde"):
        share, err = [], 0.0
        for node, cpd in vbn.nodes.items():
            got = flat_params(vbn.params[node])
            keep = got["valid"] > 0
            rows = np.concatenate([got["data_p"], got["data_x"]], 1)[keep]
            before = pool[node]
            old = np.concatenate([before["data_p"], before["data_x"]], 1)[
                before["valid"] > 0]
            new = np.concatenate(
                [np.stack([np.asarray(frame[p], np.float32)
                           for p in vbn.dag.parents(node)], 1)
                 if cpd.input_dim else np.zeros((len(frame[node]), 0)),
                 np.asarray(frame[node], np.float32).reshape(-1, 1)],
                1).astype(np.float64)
            n_pool, n_new = old.shape[0] + new.shape[0], new.shape[0]
            if rows.shape[0] != min(cpd.max_points, n_pool):
                raise AssertionError(f"{tag} {node}: {rows.shape[0]} rows kept")
            # a kept row no more often than the pool holds it (float32
            # data can hold a value twice)
            pool_count = Counter(map(tuple, np.concatenate([old, new])))
            kept_count = Counter(map(tuple, rows))
            if any(c > pool_count.get(r, 0) for r, c in kept_count.items()):
                raise AssertionError(f"{tag} {node}: a row not from the pool")
            new_set = set(map(tuple, new))
            from_new = sum(1 for r in map(tuple, rows) if r in new_set)
            k = rows.shape[0]
            mu = k * n_new / n_pool
            sd = np.sqrt(k * (n_new / n_pool) * (1 - n_new / n_pool)
                         * (n_pool - k) / max(n_pool - 1, 1))
            share.append((from_new - mu) / max(sd, 1e-9))
            if abs(share[-1]) > 5.0:
                raise AssertionError(f"{tag} {node}: new-row share z {share[-1]}")
            x = torch.linspace(-2, 2, 256).reshape(-1, 1)
            par = (torch.zeros((256, cpd.input_dim)) if cpd.input_dim else None)
            card_lp = cpd._log_prob_flat(
                vbn.params[node], x.to(vbn.device),
                None if par is None else par.to(vbn.device))
            cpu_params = {k2: v.cpu() for k2, v in vbn.params[node].items()}
            cpu_lp = cpd._log_prob_flat(cpu_params, x, par)
            err = max(err, float((card_lp.cpu() - cpu_lp).abs().max()))
            if err > 1e-4:
                raise AssertionError(f"{tag} {node}: card vs CPU {err}")
        rec.update(new_row_share_z=share, card_vs_cpu_log_density_max_abs=err)
        return rec
    worst = 0.0
    for node in vbn.nodes:
        a, b = flat_params(vbn.params[node]), flat_params(cpu.params[node])
        for key in b:
            scale = max(float(np.abs(b[key]).max(initial=0.0)), 1.0)
            worst = max(worst, float(np.abs(a[key] - b[key]).max(initial=0.0))
                        / scale)
    limit = 0.0 if tag.startswith("ct") else 1e-5
    rec.update(card_vs_cpu_max_rel=worst, limit=limit)
    if worst > limit:
        raise AssertionError(f"{tag}: card vs CPU {worst} > {limit}")
    return rec


def serve_updates(vbn_cls, defaults):
    """(u1) ms per update call on the card (fit, an update to pick the
    policy, a warm one, then U1_REPS timed), each workload's first update
    of a fresh fit held against the same update on the CPU
    (``update_card_vs_cpu``)."""
    import os
    import tempfile

    import torch

    t0 = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        for i, (tag, dag, conf, data, policy, frame) in enumerate(
                update_workloads(vbn_cls, defaults)):
            def fitted():
                v = vbn_cls(dag, seed=0)
                v.set_learning_method("node_wise", nodes_cpds=conf)
                v.fit(data)
                return v

            vbn = fitted()
            vbn.update(frame, update_method=policy)
            vbn.update(frame)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t1 = time.perf_counter()
            for _ in range(U1_REPS):
                vbn.update(frame)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1) / U1_REPS
            launches = read_launches({})
            mem = torch.cuda.max_memory_allocated()
            events = device_events_per_call(lambda: vbn.update(frame))
            check = update_card_vs_cpu(tag, vbn_cls, fitted(), frame, policy,
                                       os.path.join(tmp, f"{i}.npz"))
            log("update_main_path", workload=tag, policy=policy,
                update_rows=len(next(iter(frame.values()))),
                ms_per_update=ms, device_kernels_per_update=events,
                launches=launches, max_memory_allocated_bytes=mem, **check)
    log("update_done", seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# The grouped neural fit, LBP, Rao-Blackwellized marginalization and the
# amortizer (torch ops; the KDE paths run the KDE kernels)
# ---------------------------------------------------------------------------

N_STAR = 4  # y0..y3 of tests/test_fit_grouping.py
S_LBP = 1 << 20  # sync_fix_study.py:32
RBM_LG = {"n_samples": 512, "n_particles": 1 << 18}  # tpu_study.py:128-133
RBM_ASIA = {"n_samples": 1024, "n_particles": 1024}  # presets.py:66-71
RBM_ASIA_HOLD = 1 << 18  # particles of the pmf held against the exact one
# tests/test_amortized.py:24-50 (examples/07_amortized_inference.py)
AM_FIT = {"epochs": 60, "batch_size": 512, "hidden_dims": [64, 64]}
AM_CAT_FIT = {"epochs": 80, "batch_size": 512, "hidden_dims": [64]}
B_AM, S_AM = 1024, 512


def fit_grouped(vbn, data, grouping):
    """Fit under VBN_FIT_GROUP=``grouping``; returns (seconds, the group
    sizes that ``fit_many`` trained)."""
    import os

    import torch
    from vectorizedbayesiannetwork_torch.models.gaussian_nn import GaussianNNCPD

    sizes = []
    orig = GaussianNNCPD.fit_many

    def recording(self, params_list, *a, **k):
        sizes.append(len(params_list))
        return orig(self, params_list, *a, **k)

    os.environ["VBN_FIT_GROUP"] = grouping
    GaussianNNCPD.fit_many = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vbn.fit(data)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sizes
    finally:
        GaussianNNCPD.fit_many = orig
        os.environ.pop("VBN_FIT_GROUP", None)


def star_fit(vbn_cls, defaults, data, grouping, epochs=None):
    """(g1) the star z -> y0..y3, z linear-Gaussian, each y gaussian_nn at
    ``defaults.cpd("gaussian_nn")``'s own widths and fit budget (or
    ``epochs``)."""
    conf = defaults.cpd("gaussian_nn")
    if epochs is not None:
        conf["fit"]["epochs"] = epochs
    vbn = vbn_cls([("z", f"y{i}") for i in range(N_STAR)], seed=0)
    vbn.set_learning_method("node_wise", nodes_cpds={
        "z": defaults.cpd("linear_gaussian"),
        **{f"y{i}": dict(conf) for i in range(N_STAR)}})
    secs, sizes = fit_grouped(vbn, data, grouping)
    return vbn, secs, sizes


def slice13_g1(vbn_cls, defaults):
    """(g1) grouped against sequential on the star, 4096 rows."""
    from vectorizedbayesiannetwork_torch.models._train import batch_schedule
    from vectorizedbayesiannetwork_torch.models._optim import tree_leaves

    t0 = time.perf_counter()
    g = np.random.default_rng(0)
    z = g.normal(size=4096)
    data = {"z": z, **{f"y{i}": (0.3 + 0.2 * i) * z + 0.1 * g.normal(size=4096)
                       for i in range(N_STAR)}}
    fit = defaults.cpd("gaussian_nn")["fit"]
    _, n_batches, _ = batch_schedule(4096, fit["batch_size"])
    loop_steps = fit["epochs"] * n_batches  # a node's, and the group's
    out = {}
    for grouping in ("never", "always", "never", "always"):
        vbn, secs, sizes = star_fit(vbn_cls, defaults, data, grouping)
        loops = 1 if sizes else N_STAR
        rec = out.setdefault(grouping, {"fit_s": [], "vbn": vbn})
        rec["fit_s"].append(secs)
        rec.update(groups=sizes, loops=loops, loop_steps=loop_steps * loops)
    for grouping, rec in out.items():
        # a profiled fit of 3 epochs less one of 1, over the steps between
        ev = [device_events_per_call(lambda: star_fit(
            vbn_cls, defaults, data, grouping, epochs=e)) for e in (1, 3)]
        rec["launches_per_step"] = (ev[1] - ev[0]) / (
            2 * n_batches * rec["loops"])
    worst = 0.0
    for i in range(N_STAR):
        pg = tree_leaves(out["always"]["vbn"].params[f"y{i}"])
        ps = tree_leaves(out["never"]["vbn"].params[f"y{i}"])
        for a, b in zip(pg, ps):
            excess = (a - b).abs() - (2e-4 + 2e-3 * b.abs())
            worst = max(worst, float(excess.max()))
    for grouping, rec in out.items():
        best = min(rec["fit_s"])
        log("fit_group", workload="g1 star z -> y0..y3", rows=4096,
            grouping=grouping, groups=rec["groups"], fit_s=best,
            fit_s_runs=rec["fit_s"], loop_steps=rec["loop_steps"],
            ms_per_step=1e3 * best / rec["loop_steps"],
            launches_per_step=rec["launches_per_step"],
            epochs=fit["epochs"], batch_size=fit["batch_size"])
    log("fit_group_check", workload="g1", rtol=2e-3, atol=2e-4,
        worst_excess=worst, seconds=time.perf_counter() - t0)
    if worst > 0.0 or out["always"]["groups"] != [N_STAR]:
        raise AssertionError(f"(g1) grouped fit off the sequential one: "
                             f"excess {worst}, groups {out['always']['groups']}")


def slice13_g2(vbn_cls, defaults):
    """(g2) phase 21's (b): gauss8 with gaussian_nn at DYN_FIT, grouped
    and sequential, each served the 96 queries by LW dynamic_masks at
    S=2^16."""
    import torch
    from benchmarking.gaussian_bn import (
        generate_gaussian_inference_queries,
        random_gaussian,
    )

    t0 = time.perf_counter()
    gbn = random_gaussian(8, seed=0)
    data = gbn.sample(4096, seed=1)
    queries = generate_gaussian_inference_queries(gbn, n_queries=N_DYN, seed=2)
    qd = [{"target": q.target,
           "evidence": {k: np.array([[float(v)]], np.float32)
                        for k, v in q.evidence.items()}} for q in queries]
    conf = {**defaults.cpd("gaussian_nn"), "fit": dict(DYN_FIT)}
    kl = {}
    for grouping in ("always", "never"):
        vbn = vbn_cls({n: gbn.parents[n] for n in gbn.nodes}, seed=0)
        vbn.set_learning_method("node_wise",
                                nodes_cpds={n: dict(conf) for n in gbn.nodes})
        secs, sizes = fit_grouped(vbn, data, grouping)
        vbn.set_inference_method("likelihood_weighting", n_samples=S_NN_DYN,
                                 dynamic_masks=True)
        mom, spans = vbn.infer_posterior_moments(qd, pad_bucket=N_DYN)
        torch.cuda.synchronize()
        if mom.shape != (N_DYN, 2) or not np.isfinite(mom).all():
            raise AssertionError(f"(g2) {grouping} moments rows bad")
        kl[grouping] = gauss_kl(gbn, queries, mom, spans)
        log("fit_group", workload="g2 gauss8 gaussian_nn", rows=4096,
            grouping=grouping, groups=sizes, nodes=len(gbn.nodes), fit_s=secs,
            **{f"lw_dyn_{k}": v for k, v in kl[grouping].items()})
    log("fit_group_kl", workload="g2", queries=N_DYN, S=S_NN_DYN,
        grouped_kl_mean=kl["always"]["kl_mean"],
        sequential_kl_mean=kl["never"]["kl_mean"],
        grouped_kl_median=kl["always"]["kl_median"],
        sequential_kl_median=kl["never"]["kl_median"],
        seconds=time.perf_counter() - t0)


def kde_launches(tag, got):
    """KDE launches of an IS or LW sweep over the KDE flagship at W2's
    query, each sweep two picks and one conditional density: any other
    kernel, or another ratio, fails."""
    other = {k: v for k, v in got.items()
             if v and k not in ("kde_pick", "kde_cond", "uniforms")
             and not k.endswith(".flagged")}
    sweeps = got.get("kde_cond", 0)
    if other or sweeps < 1 or got.get("kde_pick", 0) != 2 * sweeps \
            or got.get("uniforms", 0) < 1:
        raise AssertionError(f"{tag}: launches {got}")
    return got


def slice13_lbp(lg_vbn, kde_flag, ref_w2):
    """(l1) LBP on the LG flagship's diagnosis query; (l2) over the KDE
    flagship at W2's query. Returns (l2)'s launches."""
    import torch

    t0 = time.perf_counter()
    q = flagship_diag_query()
    lg_vbn.set_inference_method("lbp", n_samples=S_LBP)
    reset_launches()
    w, samples = lg_vbn.infer_posterior(q)
    torch.cuda.synchronize()
    launches = read_launches({"uniforms": SOME})
    lbp = lg_vbn._inference
    acc = diag_accuracy(lg_vbn, q, w, samples)
    qps, windows, serve = method_qps(lg_vbn, q, B_RIS)
    log("lbp_main_path", workload="l1 LG flagship x0 | x2", B=B_RIS, S=S_LBP,
        launches=launches, smoothing_steps=lbp._last_iters,
        fallback=lbp._last_fallback, queries_per_s=qps, window_qps=windows,
        limit=0.05, seconds=time.perf_counter() - t0, **acc)
    log("serve_profile", workload="l1 LBP LG flagship",
        **profile_batch(serve, (), top=4))
    if acc["dmean_over_std"] > 0.05 or acc["dstd_over_std"] > 0.05:
        raise AssertionError(f"(l1) LBP off the closed form: {acc}")

    t0 = time.perf_counter()
    _, w2, _ = kde_flagship_queries()
    kde_flag.set_inference_method("lbp", n_samples=S_KDE)
    reset_launches()
    w, samples = kde_flag.infer_posterior(w2)
    torch.cuda.synchronize()
    from vectorizedbayesiannetwork_torch.ops._launch import LAUNCHES

    launches = kde_launches("(l2)", dict(LAUNCHES))
    lbp = kde_flag._inference
    st = kde_flag._posterior_stats(w, samples)
    served = torch.stack([st["mean"][:, 0], st["std"][:, 0]], 1)
    acc = kde_accuracy(served.double().cpu().numpy(), ref_w2)
    qps, windows, serve = method_qps(kde_flag, w2, B_KDE)
    log("lbp_main_path", workload="l2 KDE flagship x0 | x2 (W2)", B=B_KDE,
        S=S_KDE, launches=launches, smoothing_steps=lbp._last_iters,
        fallback=lbp._last_fallback, queries_per_s=qps, window_qps=windows,
        limit=0.05, seconds=time.perf_counter() - t0, **acc)
    log("serve_profile", workload="l2 LBP KDE flagship", **profile_batch(
        serve, ("kde_pick_", "kde_direct_kernel"), top=4))
    if acc["dmean_over_std"] > 0.05 or acc["dstd_over_std"] > 0.05:
        raise AssertionError(f"(l2) LBP off the KDE reference: {acc}")
    return launches


def slice13_rbm(bn, asia_vbn, lg_vbn, kde_flag):
    """(r1) RBM on the LG flagship's q_pred, (r2) over the KDE flagship
    (its LW fallback), (r3) on asia. Returns (r2)'s launches."""
    import torch

    t0 = time.perf_counter()
    q = flagship_query(B_RIS)
    lg_vbn.set_inference_method("rao_blackwellized_marginalization", **RBM_LG)
    reset_launches()
    pdf, grid = lg_vbn.infer_posterior(q)
    torch.cuda.synchronize()
    launches = read_launches({})  # every parent observed: nothing drawn
    rbm = lg_vbn._inference
    # every parent observed: one mixture component, whose (mean, std) the
    # grid mean +- stddevs * std carries
    g = grid[..., 0].double().cpu().numpy()
    mean, std = (g[:, 0] + g[:, -1]) / 2, (g[:, -1] - g[:, 0]) / (2 * rbm.stddevs)
    fit = fitted_gaussian_bn(lg_vbn)
    cf = np.array([fit.conditional("x2", {"x0": float(a), "x1": float(b)})
                   for a, b in zip(q["evidence"]["x0"][:, 0],
                                   q["evidence"]["x1"][:, 0])])
    acc = {"dmean_over_std": float(np.max(np.abs(mean - cf[:, 0]) / cf[:, 1])),
           "dstd_over_std": float(np.max(np.abs(std - cf[:, 1]) / cf[:, 1]))}
    qps, windows, serve = method_qps(lg_vbn, q, B_RIS)
    log("rbm_main_path", workload="r1 LG flagship x2 | x0, x1", B=B_RIS,
        **RBM_LG, launches=launches, fallback=rbm._last_fallback,
        queries_per_s=qps, window_qps=windows, limit=1e-4,
        finite=bool(torch.isfinite(pdf).all()),
        seconds=time.perf_counter() - t0, **acc)
    log("serve_profile", workload="r1 RBM LG flagship",
        **profile_batch(serve, (), top=4))
    if rbm._last_fallback or max(acc.values()) > 1e-4:
        raise AssertionError(f"(r1) RBM off the closed form: {acc}")

    t0 = time.perf_counter()
    w1, _, _ = kde_flagship_queries()
    kde_flag.set_inference_method("rao_blackwellized_marginalization",
                                  n_samples=S_KDE, n_particles=S_KDE)
    reset_launches()
    w, samples = kde_flag.infer_posterior(w1)
    torch.cuda.synchronize()
    r2 = read_launches({"kde_root": 1, "kde_pick": 2,
                         "uniforms": SOME})
    rbm = kde_flag._inference
    st = kde_flag._posterior_stats(w, samples)
    served = torch.stack([st["mean"][:, 0], st["std"][:, 0]], 1)
    ref = kde_reference(kde_flag, "w1",
                        w1["evidence"]["x0"][:, 0].astype(np.float64))
    acc = kde_accuracy(served.double().cpu().numpy(), ref)
    qps, windows, _ = method_qps(kde_flag, w1, B_KDE)
    log("rbm_main_path", workload="r2 KDE flagship x2 | x0 (W1)", B=B_KDE,
        S=S_KDE, launches=r2, fallback=rbm._last_fallback,
        reason=rbm._last_reason, queries_per_s=qps, window_qps=windows,
        limit=0.05, seconds=time.perf_counter() - t0, **acc)
    if not rbm._last_fallback or rbm._last_reason != (
            "unsupported target CPD for RB marginalization"):
        raise AssertionError(f"(r2) no LW fallback: {rbm._last_reason}")
    if acc["dmean_over_std"] > 0.05 or acc["dstd_over_std"] > 0.05:
        raise AssertionError(f"(r2) RBM's fallback off the reference: {acc}")

    t0 = time.perf_counter()
    qa = asia_query(B_MAIN)
    asia_vbn.set_inference_method("rao_blackwellized_marginalization",
                                  **RBM_ASIA)
    reset_launches()
    pmf, _ = asia_vbn.infer_posterior(qa)
    torch.cuda.synchronize()
    launches = read_launches({"uniforms": SOME})
    qps, windows, serve = method_qps(asia_vbn, qa, B_MAIN)
    log("serve_profile", workload="r3 RBM asia",
        **profile_batch(serve, (), top=4))
    q8 = asia_query(8)
    asia_vbn.set_inference_method("categorical_exact")
    want, _ = asia_vbn.infer_posterior(q8)
    asia_vbn.set_inference_method("rao_blackwellized_marginalization",
                                  n_samples=64, n_particles=RBM_ASIA_HOLD)
    got, _ = asia_vbn.infer_posterior(q8)
    err = float((got - want).abs().max())
    err_1024 = float((pmf[:8] - want).abs().max())
    log("rbm_main_path", workload="r3 asia P(dysp | smoke, asia)", B=B_MAIN,
        **RBM_ASIA, launches=launches, queries_per_s=qps, window_qps=windows,
        max_abs_err_vs_exact=err, held_particles=RBM_ASIA_HOLD, limit=5e-3,
        max_abs_err_1024_particles=err_1024,
        seconds=time.perf_counter() - t0)
    if asia_vbn._inference._last_fallback or not err <= 5e-3:
        raise AssertionError(f"(r3) RBM pmf off categorical_exact: {err}")
    return r2


def amortized_lg(vbn_cls, defaults):
    g = np.random.default_rng(0)
    n = 6000
    x0, x1 = g.normal(size=n), g.normal(size=n)
    data = {"x0": x0, "x1": x1, "x2": 0.5 * x0 - 0.2 * x1 + 0.1 * g.normal(size=n)}
    vbn = vbn_cls([("x0", "x2"), ("x1", "x2")], seed=0)
    vbn.set_learning_method("amortized", nodes_cpds={
        k: defaults.cpd("linear_gaussian") for k in data}, **AM_FIT)
    return vbn, data


def served_mean(vbn, q):
    pdf, samples = vbn.infer_posterior(q)
    if vbn._inference._last_fallback:
        raise AssertionError(f"(a1) fell back: {vbn._inference._last_reason}")
    return vbn._posterior_stats(pdf, samples)["mean"][:, 0].cpu().numpy()


def slice13_a1(vbn_cls, defaults):
    """(a1) the amortizer of tests/test_amortized.py on the card."""
    import torch
    from vectorizedbayesiannetwork_torch.learning.amortized import (
        amortized_forward,
    )
    from vectorizedbayesiannetwork_torch.models._optim import tree_map
    from vectorizedbayesiannetwork_torch.models._train import batch_schedule

    t_phase = time.perf_counter()
    vbn, data = amortized_lg(vbn_cls, defaults)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vbn.fit(data)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    learner = vbn._learning
    spec, net = vbn.amortized["spec"], vbn.amortized["net"]
    m = 6000 * learner.n_mask_samples + 1024 * (learner.n_do_sets
                                                + learner.n_obs_sets)
    _, n_batches, _ = batch_schedule(m, AM_FIT["batch_size"])
    steps = AM_FIT["epochs"] * n_batches
    vbn.set_inference_method("amortized", n_samples=S_AM)
    checks = {
        "forward": (served_mean(vbn, {"target": "x2", "evidence": {
            "x0": [[1.0]], "x1": [[0.0]]}})[0], 0.5, 0.08),
        "inverse": (served_mean(vbn, {"target": "x0", "evidence": {
            "x2": [[0.3]]}})[0], 0.5, 0.12),
        "do": (served_mean(vbn, {"target": "x2", "do": {"x0": [[1.0]]}})[0],
               0.5, 0.1),
    }
    q = {"target": "x2", "evidence": {
        "x0": np.linspace(-1, 1, B_AM).reshape(B_AM, 1).astype(np.float32),
        "x1": np.linspace(1, -1, B_AM).reshape(B_AM, 1).astype(np.float32)}}
    reset_launches()
    served_mean(vbn, q)
    torch.cuda.synchronize()
    launches = read_launches({"uniforms": SOME})
    qps, windows, serve = method_qps(vbn, q, B_AM)
    log("serve_profile", workload="a1 amortized LG flagship",
        **profile_batch(serve, (), top=4))

    g = np.random.default_rng(5)
    rows = torch.as_tensor(g.normal(size=(1 << 16, spec.total_dim)),
                           dtype=torch.float32, device=vbn.device)
    mask = (torch.rand((1 << 16, spec.n_nodes), device=vbn.device)
            < 0.5).float()
    do = mask * (torch.rand_like(mask) < 0.3).float()
    heads = amortized_forward(spec, net, rows, mask, do)
    cpu_heads = amortized_forward(spec, tree_map(lambda t: t.cpu(), net),
                                  rows.cpu(), mask.cpu(), do.cpu())
    heads_err = float((heads.cpu() - cpu_heads).abs().max()
                      / cpu_heads.abs().max())

    cat = vbn_cls([("a", "b")], seed=0)
    gc = np.random.default_rng(0)
    a = gc.integers(0, 3, 4000)
    b = (a + (gc.random(4000) < 0.2)) % 3
    cat.set_learning_method("amortized", nodes_cpds={
        k: dict(defaults.cpd("categorical_table"), n_classes=3) for k in "ab"},
        **AM_CAT_FIT)
    cat.fit({"a": a.astype(float), "b": b.astype(float)})
    cat.set_inference_method("amortized")
    probs, _ = cat.infer_posterior({"target": "b", "evidence": {"a": [[1.0]]}})
    probs = probs[0].cpu().numpy()
    log("amortized_main_path", workload="a1 amortized LG flagship",
        rows=6000, fit_s=secs, optimizer_steps=steps,
        fit_ms_per_step=1e3 * secs / steps, B=B_AM, n_samples=S_AM,
        launches=launches, queries_per_s=qps, window_qps=windows,
        **{f"{k}_mean": float(v[0]) for k, v in checks.items()},
        **{f"{k}_limit": v[2] for k, v in checks.items()},
        heads_card_vs_cpu_over_scale=heads_err, heads_limit=1e-5,
        categorical_pmf=probs.tolist(), categorical_limit=0.1,
        seconds=time.perf_counter() - t_phase)
    bad = {k: v for k, v in checks.items() if not abs(v[0] - v[1]) < v[2]}
    if bad or not heads_err <= 1e-5:
        raise AssertionError(f"(a1) off: {bad}, heads {heads_err}")
    if not (abs(probs[1] - 0.8) < 0.1 and abs(probs[2] - 0.2) < 0.1
            and abs(probs.sum() - 1.0) < 1e-4):
        raise AssertionError(f"(a1) categorical pmf off: {probs}")


def serve_slice13(vbn_cls, defaults, bn, asia_vbn, lg_vbn):
    """Phases g1, g2, l1, l2, r1, r2, r3 and a1; returns the KDE kernels'
    launches of (l2) and (r2)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    slice13_g1(vbn_cls, defaults)
    slice13_g2(vbn_cls, defaults)
    kde_flag = fit_kde(vbn_cls, defaults, [("x0", "x2"), ("x1", "x2")],
                       flagship_data())
    v = kde_flagship_queries()[1]["evidence"]["x2"][:, 0].astype(np.float64)
    out = {"l2": slice13_lbp(lg_vbn, kde_flag,
                             kde_reference(kde_flag, "w2", v))}
    out["r2"] = slice13_rbm(bn, asia_vbn, lg_vbn, kde_flag)
    slice13_a1(vbn_cls, defaults)
    log("slice13_done", seconds=time.perf_counter() - t0, launches=out)
    return out


# ---------------------------------------------------------------------------
# Phase 25: devices, the relative query, the stacked-table sweeps, utilities
# ---------------------------------------------------------------------------

N_STACKED = 2048  # nodes of the (t3) plans: past the scan kernels' 1500
S_STACKED = 1 << 14
KEPT = {}  # models phase 27 serves again, kept by the phases that fit them


def slice14_t1(vbn_cls, defaults, bn):
    """(t1) asia fitted on the CPU, moved to the card by ``to_device`` and
    served; saved, reloaded by ``load(map_location="cuda")`` and served at
    the same key counter; (t4) ``timed_call`` and a ``StageTimer`` around
    one more batch, and the kernels' build directory. Returns the
    launches of the moved model's batch."""
    import shutil
    import tempfile

    import torch

    from vectorizedbayesiannetwork_torch.core import cache
    from vectorizedbayesiannetwork_torch.ops import _build
    from vectorizedbayesiannetwork_torch.utils.profiling import (
        StageTimer,
        timed_call,
    )

    vbn = fit_discrete(vbn_cls, defaults, bn, device="cpu")
    t0 = time.perf_counter()
    vbn.to_device("cuda")
    torch.cuda.synchronize()
    move_s = time.perf_counter() - t0
    if any(t.device.type != vbn.device.type
           for p in vbn.params.values() for t in p.values()):
        raise AssertionError("to_device left a param behind")
    vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    qa = asia_query(B_MAIN)
    counter = vbn._keys.state()
    reset_launches()
    pmf, _ = vbn.infer_posterior_pmf([qa], n_classes=2)
    launches = read_launches({"categorical": 1})
    err = asia_pmf_error(bn, vbn, qa, pmf)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR.parent)
    try:
        vbn.save(tmp)
        loaded = vbn_cls.load(tmp, map_location="cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded._keys.set_state(counter)
    reset_launches()
    pmf2, _ = loaded.infer_posterior_pmf([qa], n_classes=2)
    launches_loaded = read_launches({"categorical": 1})
    same = bool(np.array_equal(pmf, pmf2))
    log("devices_main_path", launches=launches,
        launches_loaded=launches_loaded, to_device_s=move_s,
        asia_pmf_max_abs_err=err, loaded_rows_identical=same,
        path=loaded._last_summary_path)
    if err > 5e-3:
        raise AssertionError(f"moved asia pmf off the exact posterior: {err}")
    if not same:
        raise AssertionError("the reloaded model served other rows")

    timer = StageTimer()
    with timer.stage("t1_batch"):
        out, ms = timed_call(loaded.infer_posterior_pmf, [qa], n_classes=2)
    log("utilities", timed_call_ms=ms, stage_timer=timer.summary(),
        kernel_build_dir=str(cache.kernel_build_dir()),
        compilation_cache=cache.enable_compilation_cache(),
        matplotlib_imported="matplotlib" in sys.modules)
    if "matplotlib" in sys.modules:
        raise AssertionError("the served path imported matplotlib")
    if not np.isfinite(out[0]).all():
        raise AssertionError("timed batch rows not finite")
    return launches


def slice14_t2(lg_vbn):
    """(t2) ``infer_relative`` on the flagship by MCM: x2 | x0, x1 (B=1024)
    against the no-evidence reference, one ``infer_posterior_many`` call
    (static: the reference's ``vbn_lg_sweep``, the query's every parent
    observed takes MCM's direct CPD evaluation; with ``dynamic_masks`` one
    fused ``vbn_lg_scan`` dispatch for both); ``delta_mean``
    within 5 standard errors of the closed form of the fitted params.
    Returns the static call's launches."""
    import torch

    p = {n: lg_vbn.params[n] for n in ("x0", "x1", "x2")}
    w = p["x2"]["weight"][:, 0].double().cpu().numpy()
    mu = np.array([float(p["x0"]["bias"][0]), float(p["x1"]["bias"][0])])
    ql = flagship_query(B_MAIN)
    x = np.concatenate([ql["evidence"]["x0"], ql["evidence"]["x1"]], axis=1)
    delta_cf = (x - mu[None]) @ w  # (w.x + b) - (w.mu + b)
    out = {}
    # static: the query's MCM draws its target directly (one vbn_uniforms
    # launch), the reference's sweep is the kernel's
    for dynamic, expect in ((False, {"lg": 1, "uniforms": 1}),
                            (True, {"lg_scan": 1})):
        lg_vbn.set_inference_method("monte_carlo_marginalization",
                                    n_samples=S_MAIN, dynamic_masks=dynamic)
        reset_launches()
        rel = lg_vbn.infer_relative(ql)
        launches = read_launches(expect)
        qs, rs = rel["query_stats"], rel["reference_stats"]
        se = torch.sqrt(qs["std"] ** 2 / qs["effective_sample_size"][:, None]
                        + rs["std"] ** 2
                        / rs["effective_sample_size"][:, None])
        se = se[:, 0].double().cpu().numpy()
        dm = rel["delta_mean"][:, 0].double().cpu().numpy()
        z = np.abs(dm - delta_cf) / se
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = lg_vbn.infer_relative(ql)
            r["delta_mean"].cpu()
            times.append(time.perf_counter() - t0)
        tag = "dynamic" if dynamic else "static"
        out[tag] = launches
        log("relative_main_path", route=tag, launches=launches,
            delta_mean_max_z=float(z.max()),
            delta_mean_max_abs_err=float(np.abs(dm - delta_cf).max()),
            se_median=float(np.median(se)),
            reference_ess=float(rs["effective_sample_size"][0]),
            queries_per_s=B_MAIN / min(times),
            window_qps=[B_MAIN / t for t in times])
        if not np.isfinite(dm).all() or z.max() > 5.0:
            raise AssertionError(f"{tag} delta_mean off the closed form: "
                                 f"max z {z.max()}")
    lg_vbn.set_inference_method("monte_carlo_marginalization",
                                n_samples=S_MAIN)
    return out["static"]


def stacked_route(tag, vbn, serve, mode, timed):
    """One (t3) workload under ``VBN_DISCRETE_SCAN=mode``: the route the
    torch-op sweep took (``_sweep.ROUTES``), no hand kernel, queries/s
    (the first batch and ``timed`` more, best of them), peak memory, and
    a profiled batch: device kernels a batch, device busy ms, the longest
    ops, and the idle share against the best unprofiled batch (the
    profiler's cost per event inflates its own wall time at tens of
    thousands of small ops). The per-node loop's batch is profiled over
    its first 8 queries (its ops do not depend on the rows; a profiled
    96-query batch of it outlasted the run). ``serve(n)`` serves the
    first n queries. Returns
    the rows, spans and per-row ESS of the last 96-query batch."""
    import os

    import torch

    from vectorizedbayesiannetwork_torch.inference import _sweep

    os.environ["VBN_DISCRETE_SCAN"] = mode
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _sweep.ROUTES.clear()
        times = []
        for _ in range(1 + timed):
            t0 = time.perf_counter()
            rows, spans = serve(N_DYN)
            times.append(time.perf_counter() - t0)
        routes = dict(_sweep.ROUTES)
        ess = vbn._inference._last_ess.double().cpu().numpy()
        read_launches({"uniforms": SOME})
        mem = torch.cuda.max_memory_allocated()
        prof_n = 8 if mode == "never" else N_DYN
        prof = profile_batch(lambda: serve(prof_n), kernels=(), top=4)
    finally:
        os.environ.pop("VBN_DISCRETE_SCAN", None)
    busy = prof.get("device_busy_ms")
    log("stacked_route", workload=tag, mode=mode, routes=routes,
        path=vbn._last_summary_path, queries_per_s=N_DYN / min(times),
        window_qps=[N_DYN / t for t in times],
        max_memory_allocated_bytes=mem, profile_queries=prof_n, profile=prof,
        idle_share=None if busy is None or prof_n != N_DYN
        else 1.0 - busy / (1e3 * min(times)))
    want = "per_node" if mode == "never" else {
        "categorical": "discrete", "gaussian": "gaussian"}[tag]
    if routes != {want: 1 + timed}:
        raise AssertionError(f"{tag} {mode}: routes {routes} != {want}")
    return rows, spans, ess


def draws_by_chunk(tag, vbn, serve):
    """(t3) the stacked form's draws a chunk of nodes a ``vbn_uniforms``
    launch (``core/rng.py::ChunkedDraws``) against one node a launch (the
    chunk cut to one node: the parent commit's draws), at one key counter:
    the rows bit for bit, ``vbn_uniforms`` launches a batch, and queries/s
    in turns (one node, chunked, chunked, one node) of N_DYN queries."""
    from vectorizedbayesiannetwork_torch.core import rng

    rep = {"qps": {"one_node_a_launch": [], "chunked": []},
           "uniforms_launches": {}}
    rows = {}
    full = rng.CHUNK_BYTES
    try:
        for i, mode in enumerate(("one_node_a_launch", "chunked", "chunked",
                                  "one_node_a_launch")):
            rng.CHUNK_BYTES = 1 if mode == "one_node_a_launch" else full
            vbn._keys.set_state(800)
            reset_launches()
            t0 = time.perf_counter()
            got = serve(N_DYN)[0]
            rep["qps"][mode].append(N_DYN / (time.perf_counter() - t0))
            if i < 2:
                rep["uniforms_launches"][mode] = read_launches(
                    {"uniforms": SOME})["uniforms"]
                rows[mode] = np.asarray(got)
    finally:
        rng.CHUNK_BYTES = full
    rep["rows_equal"] = bool(np.array_equal(rows["chunked"],
                                            rows["one_node_a_launch"]))
    log("stacked_draws", workload=tag, nodes=N_STACKED, **rep)
    if not rep["rows_equal"]:
        raise AssertionError(f"{tag}: chunked draws change the rows")
    return rep["uniforms_launches"]["chunked"]


def slice14_t3(vbn_cls, defaults):
    """(t3) the stacked-table sweeps past the scan kernels' 1500 nodes:
    ``random_bn_treewidth(2048)`` (LW pmf) and ``random_gaussian(2048)``
    (LW moments), 96 queries each, S=2^14, ``dynamic_masks=True``, under
    ``VBN_DISCRETE_SCAN=auto`` (the stacked form) and ``never`` (the
    per-node loop)."""
    from benchmarking.exact import exact_posterior, min_fill_order
    from benchmarking.gaussian_bn import random_gaussian
    from benchmarking.networks import random_bn_treewidth

    from vectorizedbayesiannetwork_torch.core.base import Query
    from vectorizedbayesiannetwork_torch.core.plan import get_plan
    from vectorizedbayesiannetwork_torch.ops import sweep_scan

    t0 = time.perf_counter()
    bn = random_bn_treewidth(N_STACKED, seed=0)
    cat = fit_discrete(vbn_cls, defaults, bn)
    cat.set_inference_method("likelihood_weighting", n_samples=S_STACKED,
                             dynamic_masks=True)
    gbn = random_gaussian(N_STACKED, seed=0)
    gauss = fit_gaussian(vbn_cls, defaults, gbn)
    gauss.set_inference_method("likelihood_weighting", n_samples=S_STACKED,
                               dynamic_masks=True)
    link_qs, gauss_qs = link_queries(bn), gauss_queries(gbn)
    reasons = {}
    for tag, vbn, reason in (("categorical", cat, sweep_scan.scan_sweep_reason),
                             ("gaussian", gauss, sweep_scan.lg_scan_reason)):
        plan = get_plan(vbn, Query(target=vbn.dag.topological_order()[0],
                                   evidence={}, do={}))
        reasons[tag] = reason(plan, tuple(vbn.cpd_spec(n)
                                          for n in plan.topo_order), S_STACKED)
    log("stacked_fit", seconds=time.perf_counter() - t0, nodes=N_STACKED,
        kernel_gate=reasons)
    for tag, why in reasons.items():
        if why != f"n_nodes {N_STACKED} > {sweep_scan._MAX_NODES}":
            raise AssertionError(f"{tag} scan gate: {why!r}")

    lq = [as_query(t, ev) for t, ev in link_qs]
    KEPT["t3_cat"] = (cat, lq, link_qs)
    t0 = time.perf_counter()
    fit = fitted_discrete_bn(bn, cat, floor=1e-12)
    order = min_fill_order(fit)
    gts = [np.asarray(exact_posterior(fit, t, ev, elim_order=order))
           for t, ev in link_qs]
    exact_s = time.perf_counter() - t0
    kls = {}
    for mode, timed in (("auto", 2), ("never", 0)):
        pmf, spans, _ess = stacked_route("categorical", cat, lambda n: (
            cat.infer_posterior_pmf(lq[:n], n_classes=4, pad_bucket=n)),
            mode, timed)
        if pmf.shape != (N_DYN, 4) or not np.isfinite(pmf).all():
            raise AssertionError(f"2048-node pmf rows bad: {pmf.shape}")
        kl = []
        for (lo, _hi, _t), gt in zip(spans, gts):
            r = pmf[lo][: len(gt)].astype(np.float64)
            r = r / max(r.sum(), 1e-30)
            kl.append(float(np.sum(gt * np.log(np.maximum(gt, 1e-12)
                                               / np.maximum(r, 1e-12)))))
        kls[mode] = {"kl_median": float(np.median(kl)),
                     "kl_max": float(max(kl))}
    log("stacked_accuracy", workload="categorical", queries=len(gts),
        exact_s=exact_s, stacked=kls["auto"], per_node=kls["never"])
    launches = {"categorical": draws_by_chunk("categorical", cat, lambda n: (
        cat.infer_posterior_pmf(lq[:n], n_classes=4, pad_bucket=n)))}
    for mode, k in kls.items():
        if k["kl_median"] > 2e-3:
            raise AssertionError(f"2048-node {mode} median KL {k}")

    gq = [as_query(t, ev) for t, ev in gauss_qs]
    moms, ess = {}, {}
    for mode in ("auto", "never"):
        moms[mode], _spans, ess[mode] = stacked_route(
            "gaussian", gauss, lambda n: (
                gauss.infer_posterior_moments(gq[:n], pad_bucket=n)), mode, 2)
    launches["gaussian"] = draws_by_chunk("gaussian", gauss, lambda n: (
        gauss.infer_posterior_moments(gq[:n], pad_bucket=n)))
    gauss.set_inference_method("gaussian_exact")
    exact = np.concatenate([
        gauss.infer_posterior_moments(gq[i:i + 16])[0]
        for i in range(0, N_DYN, 16)])
    acc = {mode: gauss_stacked_accuracy(moms[mode], exact, ess[mode])
           for mode in moms}
    log("stacked_accuracy", workload="gaussian", queries=N_DYN,
        stacked=acc["auto"], per_node=acc["never"])
    for mode, a in acc.items():
        if (not np.isfinite(moms[mode]).all()
                or max(a["median_dmean_over_std"],
                       a["median_dstd_over_std"]) > 0.05
                or max(a["max_z_mean"], a["max_z_std"]) > 5.0):
            raise AssertionError(f"2048-node LG {mode} off gaussian_exact: {a}")
    return launches


def gauss_stacked_accuracy(mom, exact, ess):
    """(t3)'s Gaussian rows against ``gaussian_exact``: |Δmean| and |Δstd|
    over the exact std, their medians (limit 0.05) and worst rows
    (reported), and each row's error in standard errors of its own LW
    estimate, std / sqrt(ESS) for the mean and std / sqrt(2 ESS) for the
    std (limit 5). At S=2^14 a row's ESS falls to a few hundred, where one
    standard error is several hundredths of the std."""
    sd = exact[:, 1]
    dm = np.abs(mom[:, 0] - exact[:, 0]) / sd
    ds = np.abs(mom[:, 1] - sd) / sd
    ess = np.maximum(ess, 1.0)
    return {"median_dmean_over_std": float(np.median(dm)),
            "median_dstd_over_std": float(np.median(ds)),
            "max_dmean_over_std": float(dm.max()),
            "max_dstd_over_std": float(ds.max()),
            "max_z_mean": float((dm * np.sqrt(ess)).max()),
            "max_z_std": float((ds * np.sqrt(2.0 * ess)).max()),
            "min_ess": float(ess.min())}


def serve_slice14(vbn_cls, defaults, bn, lg_vbn):
    """Phase 25: (t1) with (t4), (t2), (t3); returns the sweep kernels'
    launches of (t1) and (t2), and ``vbn_uniforms``'s of a (t3) batch."""
    t0 = time.perf_counter()
    out = {"t1": slice14_t1(vbn_cls, defaults, bn),
           "t2": slice14_t2(lg_vbn)}
    t3 = slice14_t3(vbn_cls, defaults)
    out["t3"] = {"uniforms": t3["categorical"]}
    out["t3_gaussian"] = {"uniforms": t3["gaussian"]}
    log("slice14_done", seconds=time.perf_counter() - t0, launches=out)
    return out


# ---------------------------------------------------------------------------
# Phase 27: the row stream (vbn_uniforms) and row-0 batch invariance; its
# mesh part (m3) runs inside phase 26
# ---------------------------------------------------------------------------

B_M3 = 8  # (m3) and the invariance case: t3's queries cut to 8 rows
STREAM_SEED = 0x5EED5EED12345678


# Hopper's issue rates, results an SM a clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0): 32-bit
# integer multiply and multiply-add (IMAD, IMAD.HI), and the ALU's bitwise
# ops (LOP3), half the float32 rate; conversions (I2F) a quarter of that;
# one warp instruction a scheduler a clock (4 x 32 thread instructions)
RATE_IMUL, RATE_ALU, RATE_CVT, RATE_FP32, RATE_ISSUE = 64, 64, 16, 128, 128
SM_CLOCKS = 132 * 1.98e9  # SMs x boost clock (the basis of PEAK_OPS)
PHILOX_CALL = {"imul": 40, "alu": 20}  # a round: 2 IMAD.HI.U32 + 2 IMAD, 2 LOP3
UNIFORM_VALUE = {"alu": 1, "cvt": 1, "fp32": 3}  # SHF, I2F; FADD, FMUL, FMNMX
UNIFORMS_PER = 4  # csrc/rng.cu's PER: chains a thread, so Philox calls in the code


def uniforms_bound(m, k, g=1):
    """(bound ms, what bounds it, detail) of ``vbn_uniforms`` writing g
    nodes' [m, k] uniforms: per particle and node ceil(k / 4) Philox calls
    (each particle has its own counter, so its first word costs a whole
    call), per value its conversion, each instruction class at its issue
    rate (the pipes run side by side, all bounded by the issue rate), and
    the output's bytes written once."""
    calls, vals = g * m * -(-k // 4), g * m * k
    work = {c: calls * PHILOX_CALL.get(c, 0) + vals * UNIFORM_VALUE.get(c, 0)
            for c in ("imul", "alu", "cvt", "fp32")}
    cycles = {"imul": work["imul"] / RATE_IMUL, "alu": work["alu"] / RATE_ALU,
              "cvt": work["cvt"] / RATE_CVT, "fp32": work["fp32"] / RATE_FP32,
              "issue": sum(work.values()) / RATE_ISSUE}
    pipe = max(cycles, key=cycles.get)
    t_ops = 1e3 * cycles[pipe] / SM_CLOCKS
    t_bytes = 1e3 * 4 * vals / PEAK_BYTES
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            {"ops_ms": t_ops, "bytes_ms": t_bytes, "limiting_pipe": pipe,
             "instructions": work})


def uniforms_sass():
    """The SASS of ``csrc/rng.cu``'s uniform k-any instances (``cuobjdump
    -sass``): per instance the counts of the integer multiply, bitwise,
    conversion and store opcodes, and per Philox call (the code holds
    UNIFORMS_PER interleaved calls) its multiplies and LOP3s: the
    instruction mix the bound prices."""
    from pathlib import Path

    from vectorizedbayesiannetwork_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(_build.library_path("rng"))],
                          check=True, capture_output=True, text=True,
                          timeout=120).stdout
    out = []
    for body in text.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        m = re.search(r"uniforms_kernelI([jm])Lb([01])E", name)
        if not m:
            continue
        ops = Counter()
        for line in body.splitlines():
            op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                          r"([A-Z][A-Z0-9_.]*)", line)
            if op and op.group(1) != "NOP":
                ops[op.group(1)] += 1
        imul = (ops["IMAD"] + ops["IMAD.HI.U32"]  # 32-bit results
                + 2 * ops["IMAD.WIDE.U32"])
        out.append({
            "index": "uint32" if m.group(1) == "j" else "uint64",
            "normal": m.group(2) == "1", "instructions": sum(ops.values()),
            "counts": {o: n for o, n in sorted(ops.items()) if o.split(".")[0]
                       in ("IMAD", "LOP3", "I2FP", "I2F", "STG", "SHF")},
            "per_philox_call": {"imul": imul / UNIFORMS_PER,
                                "lop3": ops["LOP3.LUT"] / UNIFORMS_PER}})
    return out


def check_uniforms(dev):
    """``vbn_uniforms`` against its plain version (``core/rng.py``, int64
    torch ops on the card) at W1's [8, 2^20] and t3's [96, 2^14] rows, one
    node a launch and (t3) 64: uniforms bit for bit (k = 1 and 4, a block
    off the origin), normals within 2e-6 of |z| + 1; the wrapper's ms
    (CUDA events around the call) beside the kernel's device ms
    (``graph_ms``), the plain version's and ``torch.rand``'s of the
    same numel; the bound priced from the kernel's SASS mix. Returns the
    kernel line's row (``launches`` filled by phase 26's (m3))."""
    import torch

    from vectorizedbayesiannetwork_torch.core.rng import (
        stream_values_many as plain,
    )
    from vectorizedbayesiannetwork_torch.ops import rng

    t0 = time.perf_counter()
    err, shapes = 0.0, {}
    cases = (("w1", B_KDE, S_KDE, [5]), ("t3", N_DYN, S_STACKED, [5]),
             ("t3_g64", N_DYN, S_STACKED, list(range(5, 69))))
    for tag, b, s, nodes in cases:
        for k, at, r0, p0 in ((1, 0, 0, 0), (4, 2, 3, 1 << 12)):
            if len(nodes) > 1 and k > 1:
                continue
            got = rng.stream_values_many(STREAM_SEED, b, s, nodes, k, at=at,
                                         row0=r0, particle0=p0, device=dev)
            want = plain(STREAM_SEED, b, s, nodes, k, at=at, row0=r0,
                         particle0=p0, device=dev)
            if not torch.equal(got, want):
                raise AssertionError(f"vbn_uniforms {tag} k={k}: "
                                     f"{int((got != want).sum())} values differ")
            del got, want
        z = rng.stream_values_many(STREAM_SEED, b, s, nodes, 1, normal=True,
                                   device=dev)
        zp = plain(STREAM_SEED, b, s, nodes, 1, normal=True, device=dev)
        e = float(((z - zp).abs() / (zp.abs() + 1.0)).max())
        err = max(err, float((z - zp).abs().max()))
        del z, zp
        if e > 2e-6:
            raise AssertionError(f"vbn_uniforms normals {tag}: {e} > 2e-6")
        m, g = b * s, len(nodes)
        call = lambda: rng.stream_values_many(  # noqa: E731
            STREAM_SEED, b, s, nodes, 1, device=dev)
        bound_ms, by, detail = uniforms_bound(m, 1, g)
        shapes[tag] = {
            "rows": [b, s], "nodes": g,
            "ms": cuda_ms(call, 5),
            "device_ms": graph_ms(call, 5),
            "normal_ms": cuda_ms(lambda: rng.stream_values_many(
                STREAM_SEED, b, s, nodes, 1, normal=True, device=dev), 5),
            "plain_ms": cuda_ms(lambda: plain(STREAM_SEED, b, s, nodes, 1,
                                              device=dev), 1),
            "torch_rand_ms": cuda_ms(lambda: torch.rand((g * m, 1), device=dev),
                                     5),
            "bound_ms": bound_ms, "bound_by": by, "bound": detail,
        }
        shapes[tag]["share"] = bound_ms / shapes[tag]["device_ms"]
        shapes[tag]["device_ms_per_node"] = shapes[tag]["device_ms"] / g
    sass = uniforms_sass()
    log("uniforms_kernel_check", normals_max_abs_err=err, shapes=shapes,
        sass=sass, seconds=time.perf_counter() - t0)
    w1 = shapes["w1"]
    row = kernel_row(
        "vbn_uniforms", "none: the JAX package draws in XLA "
        "(vectorizedbayesiannetwork_tpu/inference/_sweep.py:188)", 0, err,
        w1["ms"], w1["plain_ms"], (0, 4 * B_KDE * S_KDE),
        source="vectorizedbayesiannetwork_torch/csrc/rng.cu")
    row.update(bound_ms=w1["bound_ms"], bound_by=w1["bound_by"],
               ops=w1["bound"]["instructions"], device_ms=w1["device_ms"],
               torch_rand_ms=w1["torch_rand_ms"], normal_ms=w1["normal_ms"],
               t3_shape=shapes["t3"], t3_g64=shapes["t3_g64"])
    return row


def row0_case(tag, vbn, serve):
    """Row 0 of a batch of two against a batch of one at key counter 500:
    ``serve(b)`` -> (weights [b, ...], samples [b, ...]). Weights within
    1e-6, samples bit for bit."""
    import torch

    outs = []
    for b in (2, 1):
        vbn._keys.set_state(500)
        w, s = serve(b)
        outs.append((torch.as_tensor(w).float().cpu(),
                     torch.as_tensor(s).float().cpu()))
    (wb, sb), (ws, ss) = outs
    dw = float((wb[0] - ws[0]).abs().max())
    ds = int((sb[0] != ss[0]).sum())
    apart = not torch.equal(sb[0], sb[1])
    log("row0_invariance", workload=tag, weights_max_abs_diff=dw,
        samples_differing=ds, rows_draw_apart=apart)
    if dw > 1e-6 or ds or not apart:
        raise AssertionError(f"{tag}: row 0 of B=2 != B=1 (weights {dw}, "
                             f"{ds} samples, rows apart {apart})")
    return {"weights_max_abs_diff": dw, "samples_differing": ds}


def many_rows(outs):
    """``infer_posterior_many``'s per-query (weights, samples) as one batch
    of rows (every target one-dimensional)."""
    import torch

    return (torch.cat([torch.as_tensor(w) for w, _ in outs]),
            torch.cat([torch.as_tensor(s) for _, s in outs]))


def row0_invariance(lg_vbn):
    """Row-0 batch invariance on the card for W1 (KDE LW), (b) gaussian_nn
    LW dynamic, t3's stacked categorical form (8 queries of the 2048-node
    plan), IS and RIS on the diagnosis query. Returns each case's diffs."""
    import os

    t0 = time.perf_counter()
    out = {}
    flag = KEPT["kde_flag"]
    w1, _w2, _ = kde_flagship_queries()
    flag.set_inference_method("likelihood_weighting", n_samples=S_KDE)

    def rows_of(q, b):
        return {**q, "evidence": {k: v[:b] for k, v in q["evidence"].items()}}

    out["W1"] = row0_case("W1 kde_flagship_lw", flag,
                          lambda b: flag.infer_posterior(rows_of(w1, b)))
    nn, qd = KEPT["b_gaussian_nn"]
    nn.set_inference_method("likelihood_weighting", n_samples=S_NN_DYN,
                            dynamic_masks=True)
    out["b"] = row0_case("(b) gauss8 gaussian_nn LW dynamic", nn,
                         lambda b: many_rows(nn.infer_posterior_many(qd[:b])))
    cat, lq, _ = KEPT["t3_cat"]
    cat.set_inference_method("likelihood_weighting", n_samples=S_STACKED,
                             dynamic_masks=True)
    os.environ["VBN_DISCRETE_SCAN"] = "always"
    try:
        out["t3"] = row0_case("t3 stacked categorical (8 queries)", cat,
                              lambda b: many_rows(
                                  cat.infer_posterior_many(lq[:b])))
    finally:
        os.environ.pop("VBN_DISCRETE_SCAN", None)
    q = flagship_diag_query()
    for tag, method, kw in (
            ("IS", "importance_sampling", {}),
            ("RIS", "resampled_importance_sampling",
             {"ess_threshold": 0.99, "resample_method": "systematic"})):
        lg_vbn.set_inference_method(method, n_samples=S_RIS, **kw)
        out[tag] = row0_case(f"{tag} flagship diagnosis", lg_vbn,
                             lambda b: lg_vbn.infer_posterior(rows_of(q, b)))
    lg_vbn.set_inference_method("monte_carlo_marginalization", n_samples=S_MAIN)
    out.update(row0_samplers(lg_vbn, flag))
    log("row0_invariance_done", seconds=time.perf_counter() - t0)
    return out


ROW0_CHAINS = {  # (s3)'s network: short runs of each chain sampler
    "gibbs": {"n_samples": 64, "burn_in": 10, "n_steps": 2, "n_chains": 4},
    "hmc": dict(S4, n_samples=64, burn_in=10),
    "nuts": dict(S4, n_samples=64, burn_in=10, max_tree_depth=4),
}


def row0_samplers(lg_vbn, flag):
    """Row 0 of B=2 against B=1 at key counter 500, samples bit for bit,
    for Gibbs, HMC and NUTS on the LG flagship (x0 | x2, at a fixed step)
    and HMC over the KDE flagship at W2's query; with the ``vbn_uniforms``
    launches of each B=2 call (its chains' draws)."""
    import torch

    def rows_of(q, b):
        return {**q, "evidence": {k: v[:b] for k, v in q["evidence"].items()}}

    def case(tag, vbn, q, kw):
        reset_launches()
        vbn._keys.set_state(500)
        vbn.sample(rows_of(q, 2), **kw)
        launches = read_launches({"uniforms": SOME, "kde_pick": SOME,
                                  "kde_root": SOME, "kde_cond": SOME}
                                 if vbn is flag else {"uniforms": SOME})
        rec = row0_case(tag, vbn, lambda b: (
            torch.zeros(b), vbn.sample(rows_of(q, b), **kw)))
        return dict(rec, uniforms=launches["uniforms"])

    out = {}
    q = flagship_diag_query()
    for name, kw in ROW0_CHAINS.items():
        lg_vbn.set_sampling_method(name)
        out[f"{name}_lg"] = case(f"{name} LG flagship x0 | x2", lg_vbn, q, kw)
    _, w2, _ = kde_flagship_queries()
    flag.set_sampling_method("hmc")
    out["hmc_kde"] = case("hmc KDE flagship, W2's query", flag, w2,
                          dict(S4_KDE, n_samples=64, burn_in=5))
    return out


# ---------------------------------------------------------------------------
# Phase 28: the level-grouped per-node sweep (VBN_LEVEL_GROUP)
# ---------------------------------------------------------------------------

S_LG_STAR = 1 << 18  # the star's depth
LG_TURNS = ("never", "auto", "auto", "never")


def level_group_star(vbn_cls, defaults):
    """The star of the JAX grouping test (``tests/test_level_grouping.py:
    23-54``: z -> y0..y3 -> t on 800 rows) with ``gaussian_nn`` siblings
    at ``defaults.cpd("gaussian_nn")``'s widths and DYN_FIT."""
    g = np.random.default_rng(0)
    n = 800
    z = g.normal(size=n)
    data = {"z": z}
    for i in range(N_STAR):
        data[f"y{i}"] = (0.4 + 0.2 * i) * z + 0.1 * g.normal(size=n)
    data["t"] = sum(data[f"y{i}"] for i in range(N_STAR)) + 0.1 * g.normal(
        size=n)
    vbn = vbn_cls([("z", f"y{i}") for i in range(N_STAR)]
                  + [(f"y{i}", "t") for i in range(N_STAR)], seed=0)
    sib = {**defaults.cpd("gaussian_nn"), "fit": dict(DYN_FIT)}
    vbn.set_learning_method("node_wise", nodes_cpds={
        "z": defaults.cpd("linear_gaussian"),
        "t": defaults.cpd("linear_gaussian"),
        **{f"y{i}": dict(sib) for i in range(N_STAR)}})
    t0 = time.perf_counter()
    vbn.fit({k: v.astype(np.float32).reshape(-1, 1) for k, v in data.items()})
    return vbn, time.perf_counter() - t0


def level_group_case(tag, vbn, serve, b, check, mlp=None):
    """One static plan under ``VBN_LEVEL_GROUP`` never and auto in turns
    (never, auto, auto, never): each turn's queries/s (best of two
    batches), ``vbn_uniforms`` launches a batch and the level groups
    (``_sweep.GROUPS``); a profiled batch of each mode (device kernels a
    batch, idle share); the two modes' answers at one key counter, grouped
    against ungrouped at the JAX grouping test's tolerances (samples rtol
    1e-4, atol 1e-4; weights rtol 1e-4, atol 1e-5); and ``check(w, s)``,
    the cell's own limit, on the grouped answer. A grouped batch launches
    one ``vbn_uniforms`` a group where ungrouped launches one a node;
    ``mlp`` gives each mode's ``vbn_gauss_mlp`` launches a batch (none
    where it is not given: a vmapped group's forward takes the plain
    route)."""
    import os

    import torch

    from vectorizedbayesiannetwork_torch.inference import _sweep

    rep = {"workload": tag, "B": b, "qps": {"never": [], "auto": []},
           "uniforms_launches": {}, "gauss_mlp_launches": {}, "groups": {},
           "profile": {}}
    answers = {}
    try:
        for i, mode in enumerate(LG_TURNS):
            os.environ["VBN_LEVEL_GROUP"] = mode
            best = 0.0
            for _ in range(2):
                torch.cuda.synchronize()
                reset_launches()
                _sweep.GROUPS.clear()
                t0 = time.perf_counter()
                serve()
                torch.cuda.synchronize()
                best = max(best, b / (time.perf_counter() - t0))
            rep["qps"][mode].append(best)
            if i < 2:
                got = read_launches({"uniforms": SOME,
                                     "gauss_mlp": (mlp or {}).get(mode, 0)})
                rep["uniforms_launches"][mode] = got["uniforms"]
                rep["gauss_mlp_launches"][mode] = got["gauss_mlp"]
                rep["groups"][mode] = dict(_sweep.GROUPS)
                rep["profile"][mode] = profile_batch(serve, (), top=4)
                vbn._keys.set_state(700)
                w, s = vbn.infer_posterior(serve.query)
                answers[mode] = (w.float(), s.float())
    finally:
        os.environ.pop("VBN_LEVEL_GROUP", None)
    (wg, sg), (wn, sn) = answers["auto"], answers["never"]
    rep["samples_max_abs_diff"] = float((sg - sn).abs().max())
    rep["weights_max_abs_diff"] = float((wg - wn).abs().max())
    close = (bool(((sg - sn).abs() <= 1e-4 + 1e-4 * sn.abs()).all())
             and bool(((wg - wn).abs() <= 1e-5 + 1e-4 * wn.abs()).all()))
    grouped = rep["groups"]["auto"]
    saved = grouped.get("sample_nodes", 0) - grouped.get("sample_calls", 0)
    launches = rep["uniforms_launches"]
    rep["limit"] = check(wg, sg)
    log("level_group", **rep, grouped_equals_ungrouped=close)
    if not close:
        raise AssertionError(f"{tag}: grouped != ungrouped")
    if rep["groups"]["never"] or not grouped.get("sample_calls"):
        raise AssertionError(f"{tag}: groups {rep['groups']}")
    if launches["auto"] != launches["never"] - saved:
        raise AssertionError(f"{tag}: uniforms launches {launches}, "
                             f"{saved} nodes grouped away")
    return launches["auto"]


class ServedQuery:
    """A serve() callable that also names its query (level_group_case
    re-serves it at a key counter to compare the modes)."""

    def __init__(self, vbn, query, fetch):
        self.vbn, self.query, self.fetch = vbn, query, fetch

    def __call__(self):
        return self.fetch(self.vbn.infer_posterior(self.query))


def serve_level_group(vbn_cls, defaults):
    """Phase 28: three static plans, never and auto in turns
    (``level_group_case``): the star (LW t | z, B=8, S=2^18; the four
    siblings one group), (a) the neural flagship by IS (B=8, S=2^18; the
    roots x0, x1 one group; (mean, std) within 0.05 std of the grid
    reference) and (c) asia ``categorical_embedded_softmax`` LW (B=8,
    S=2^20; tub, lung, bronc one group; pmf within 5e-3 of
    ``categorical_exact``). Returns the ``vbn_uniforms`` launches of a
    grouped batch of each."""
    import torch

    t0 = time.perf_counter()
    star, fit_s = level_group_star(vbn_cls, defaults)
    log("level_group_fit", workload="star gaussian_nn", fit_s=fit_s)
    star.set_inference_method("likelihood_weighting", n_samples=S_LG_STAR)
    zq = {"target": "t", "evidence": {"z": np.linspace(-1, 1, B_NN).reshape(
        B_NN, 1).astype(np.float32)}}

    def moments(out):
        w, s = out
        st = star._posterior_stats(w, s.float())
        return st["mean"].cpu()

    def star_check(w, s):
        st = star._posterior_stats(w, s)
        mean = st["mean"][:, 0].cpu().numpy()
        if not (np.isfinite(mean).all() and np.all(np.diff(mean) > 0)):
            raise AssertionError(f"star: t | z means {mean}")
        return {"t_mean_rises_with_z": True}

    # ungrouped, each sibling's draw is one vbn_gauss_mlp launch
    out = {"star": level_group_case("star gaussian_nn LW", star,
                                    ServedQuery(star, zq, moments), B_NN,
                                    star_check, {"never": N_STAR, "auto": 0})}

    a, qa, ref = KEPT["a_flagship"]
    a.set_inference_method("importance_sampling", n_samples=S_NN_IS)

    def a_check(w, s):
        st = a._posterior_stats(w, s)
        got = np.stack([st["mean"][:, 0].double().cpu().numpy(),
                        st["std"][:, 0].double().cpu().numpy()], 1)
        dm = float(np.max(np.abs(got[:, 0] - ref[:, 0]) / ref[:, 1]))
        ds = float(np.max(np.abs(got[:, 1] - ref[:, 1]) / ref[:, 1]))
        if not (dm <= 0.05 and ds <= 0.05):
            raise AssertionError(f"(a) grouped IS off the grid: {dm}, {ds}")
        return {"dmean_over_std": dm, "dstd_over_std": ds, "limit": 0.05}

    def a_means(out):
        return a._posterior_stats(out[0], out[1].float())["mean"].cpu()

    out["a"] = level_group_case("a flagship gaussian_nn+mdn IS", a,
                                ServedQuery(a, qa, a_means), B_NN, a_check)

    c = KEPT["c_emb"]
    qc = asia_query(B_NN)
    c.set_inference_method("categorical_exact")
    exact_pmf, _ = c.infer_posterior_pmf([qc], n_classes=2)
    exact_pmf = exact_pmf.astype(np.float64)
    exact_pmf /= exact_pmf.sum(axis=1, keepdims=True)  # rows come unnormalized
    c.set_inference_method("likelihood_weighting", n_samples=S_MAIN)

    def c_pmf(out):  # dysp is binary: P(1) is the weighted mean
        p1 = c._posterior_stats(out[0].double(), out[1].double())["mean"]
        return torch.cat([1 - p1, p1], 1).cpu().numpy()

    def c_check(w, s):
        pmf = c_pmf((w, s))
        err = float(np.abs(pmf - exact_pmf).max())
        if not err <= 5e-3:
            raise AssertionError(f"(c) grouped LW pmf off exact by {err}")
        return {"max_abs_err_vs_categorical_exact": err, "limit": 5e-3}

    out["c"] = level_group_case("c asia categorical_embedded_softmax LW", c,
                                ServedQuery(c, qc, c_pmf), B_NN, c_check)
    log("level_group_done", seconds=time.perf_counter() - t0, launches=out)
    return out


# ---------------------------------------------------------------------------
# Phase 29: each kernel route against the torch route it stands in for,
# the torch route called directly (the port has no route switch)
# ---------------------------------------------------------------------------

B_TR = 8  # rows of a torch-route workload: W1's, RIS's
TR_TURNS = ("kernel", "torch", "torch", "kernel")


def route_turns(tag, routes, expect, b, close, profile=True):
    """``routes["kernel"]()`` against ``routes["torch"]()`` on the same
    inputs, in turns (kernel, torch, torch, kernel; one call a turn, after
    a warm call of each): a route's first turn gives its launches
    (``read_launches(expect[route])``: the torch route's kernels 0) and its
    answer (``close(kernel, torch)`` holds the two within the limit), and
    with ``profile`` one profiled call of each follows (wall / device busy
    ms, idle share). Returns the report: calls/s of each turn."""
    import torch

    rep = {"workload": tag, "B": b, "launches": {},
           "per_s": {"kernel": [], "torch": []}, "profile": {}}
    answers = {}
    for route in ("kernel", "torch"):
        routes[route]()
    for route in TR_TURNS:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = routes[route]()
        torch.cuda.synchronize()
        rep["per_s"][route].append(1.0 / (time.perf_counter() - t0))
        if route not in answers:
            answers[route] = got
            rep["launches"][route] = {
                k: v for k, v in read_launches(expect[route]).items() if v}
    if profile:
        for route in ("kernel", "torch"):
            rep["profile"][route] = profile_batch(routes[route], (), top=3)
    rep["accuracy"] = close(answers["kernel"], answers["torch"])
    p = rep["per_s"]
    rep["torch_over_kernel"] = sum(p["torch"]) / sum(p["kernel"])
    log("torch_routes", **rep)
    return rep


def sweep_torch_route(vbn, q, s):
    """The torch-op sweep (``inference/_sweep.py::sweep_trace``) that a
    static LW or MCM plan's sweep kernel stands in for, called directly on
    the served call's plan, rows and key stream: (pdf [B, S], target
    samples [B, S, 1]), as ``vbn.infer_posterior(q)`` returns them."""
    import torch

    from vectorizedbayesiannetwork_torch.core.plan import pack_fixed_values
    from vectorizedbayesiannetwork_torch.inference import _sweep

    m = vbn._inference
    query = vbn._normalize_query(q)
    plan, b = m._plan_and_batch(vbn, query)
    lw = hasattr(m, "_weights_from_logw")
    fixed = torch.as_tensor(pack_fixed_values(query, plan, b, clamp_obs=lw),
                            device=vbn.device)
    cpds, params = m._cpds(vbn, plan), m._params_tuple(vbn, plan)
    t = plan.target_idx
    if lw:
        tv, log_w = _sweep.sweep_trace(plan, cpds, params, vbn.next_key(),
                                       fixed, s, weighted=True, target=t)
        return m._weights_from_logw(log_w, m.normalize)[0], tv
    packed, _ = _sweep.sweep_trace(plan, cpds, params, vbn.next_key(), fixed, s)
    lp = _sweep.target_log_prob(plan, cpds, params, packed)
    return torch.exp(lp), _sweep.node_values(plan, packed, t)


def weighted_moments(out):
    """[B, 2] (mean, std) of the target under (pdf, samples), float64."""
    import torch

    w, x = (t.double() for t in out)
    w = w / w.sum(dim=1, keepdim=True)
    mean = (w * x[..., 0]).sum(dim=1)
    var = (w * (x[..., 0] - mean[:, None]) ** 2).sum(dim=1)
    return torch.stack([mean, var.clamp(min=0).sqrt()], 1).cpu().numpy()


def serve_torch_routes(asia_vbn, lg_vbn):
    """Phase 29: each kernel against the torch route it stands in for, the
    torch route called directly (``route_turns``): asia LW (B=8, S=2^20)
    and flagship MCM of x2 | x0 (B=8, S=2^20), the served call against
    ``sweep_torch_route``, class frequencies within 5e-3, moments within
    0.05 std; flagship RIS's resampling event at its shape ([8, 2^20]
    particles of the 3 nodes), ``systematic_resample_gather`` (one
    ``vbn_cumsum`` and one ``vbn_srg``) against the index form of
    ``ops/resample.py`` on the same u0, the particles picked equal but for
    0.1 % of positions (CDF entries rounded apart); W1's Dp=2 pick
    ([8 x 2^20] rows over x2's 2,048 points), ``kde_pick`` against the
    chunked inverse-CDF form ``kde_sample_indices`` on the kernel's own
    uniforms, equal but for 1 % of rows. Returns each case's report."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import kde_fused as kf
    from vectorizedbayesiannetwork_torch.ops import resample as rs
    from vectorizedbayesiannetwork_torch.ops import resample_merge as rm
    from vectorizedbayesiannetwork_torch.ops.kde_kernel import (
        kde_sample_indices,
    )

    t0 = time.perf_counter()
    out = {}

    def freq_close(a, b):
        fa = [((a[0] * (a[1][..., 0] == c)).sum(1) / a[0].sum(1))
              for c in (0, 1)]
        fb = [((b[0] * (b[1][..., 0] == c)).sum(1) / b[0].sum(1))
              for c in (0, 1)]
        err = float(max((x - y).abs().max() for x, y in zip(fa, fb)))
        if not err <= 5e-3:
            raise AssertionError(f"torch route: class frequencies apart by "
                                 f"{err}")
        return {"freq_max_abs_diff": err, "limit": 5e-3}

    def mom_close(a, b):
        a, b = weighted_moments(a), weighted_moments(b)
        dm = float(np.max(np.abs(a[:, 0] - b[:, 0]) / a[:, 1]))
        ds = float(np.max(np.abs(a[:, 1] - b[:, 1]) / a[:, 1]))
        if not (dm <= 0.05 and ds <= 0.05):
            raise AssertionError(f"torch route: moments apart by {dm}, {ds} "
                                 f"std")
        return {"dmean_over_std": dm, "dstd_over_std": ds, "limit": 0.05}

    qa = asia_query(B_TR)
    asia_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    out["asia_lw"] = route_turns(
        "asia LW (B=8, S=2^20)",
        {"kernel": lambda: asia_vbn.infer_posterior(qa),
         "torch": lambda: sweep_torch_route(asia_vbn, qa, S_MAIN)},
        {"kernel": {"categorical": 1}, "torch": {"uniforms": SOME}}, B_TR,
        freq_close)
    # x2 | x0: x1 is drawn, so the static program sweeps (x2 | x0, x1
    # evaluates x2's CPD directly, with no sweep in either route)
    ql = {"target": "x2",
          "evidence": {"x0": flagship_query(B_TR)["evidence"]["x0"]}}
    lg_vbn.set_inference_method("monte_carlo_marginalization", n_samples=S_MAIN)
    out["flagship_mcm"] = route_turns(
        "flagship MCM x2 | x0 (B=8, S=2^20)",
        {"kernel": lambda: lg_vbn.infer_posterior(ql),
         "torch": lambda: sweep_torch_route(lg_vbn, ql, S_MAIN)},
        {"kernel": {"lg": 1}, "torch": {"uniforms": SOME}}, B_TR, mom_close)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    w = torch.rand((B_RIS, S_RIS), generator=g, device=dev) ** 4
    vals = torch.randn((B_RIS, S_RIS, 3), generator=g, device=dev)
    u0 = torch.rand((B_RIS, 1), generator=g, device=dev)

    def mean_close(a, b):
        """The two routes' picks as [B, 2^20, D]: the share of equal picks
        (logged) and each row's mean over its picks, held within 0.01 (ten
        standard errors of a mean of 2^20 unit draws)."""
        a, b = (t.reshape(-1, S_RIS, t.shape[-1]) for t in (a, b))
        share = float((a == b).all(dim=-1).double().mean())
        err = float((a.double().mean(1) - b.double().mean(1)).abs().max())
        if not err <= 0.01:
            raise AssertionError(f"torch route: row means apart by {err}")
        return {"same_share": share, "row_mean_max_abs_diff": err,
                "limit": 0.01}

    out["ris_resample"] = route_turns(
        "flagship RIS resampling event ([8, 2^20] x 3)",
        {"kernel": lambda: rm.systematic_resample_gather(w, vals, u0=u0),
         "torch": lambda: rs.gather_particles(
             vals, rs.systematic_resample_indices(w, u0=u0))},
        {"kernel": {"cumsum": 1, "srg": 1}, "torch": {}}, B_RIS, mean_close)

    flag = KEPT["kde_flag"]
    p2 = flag.params["x2"]
    dx2, dp2 = p2["data_x"], p2["data_p"]
    lm2 = flag.nodes["x2"]._log_mask(p2)
    hp2 = flag.nodes["x2"]._p_scale()
    m = B_KDE * S_KDE
    ev = torch.linspace(-1, 1, B_KDE, device=dev).repeat_interleave(S_KDE)
    par = torch.stack([ev, torch.randn(m, generator=g, device=dev)], 1)
    key = kf.pick_key(g, dev)
    out["w1_pick"] = route_turns(
        "W1 x2 pick (Dp=2, [8 x 2^20] rows)",
        {"kernel": lambda: kf.kde_pick(key, par, dp2, dx2, lm2, hp2, m),
         "torch": lambda: dx2[kde_sample_indices(
             kf.pick_uniforms(key, m), par, dp2, lm2, hp2, m)]},
        {"kernel": {"kde_pick": 1}, "torch": {}}, B_KDE, mean_close)
    lg_vbn.set_inference_method("monte_carlo_marginalization", n_samples=S_MAIN)
    asia_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    torch.cuda.synchronize()
    log("torch_routes_done", seconds=time.perf_counter() - t0)
    return out


def m3_serve(mesh, cat, lq):
    """(m3) t3's stacked categorical form (the 2048-node plan, its first
    B_M3 queries, S=2^14, LW dynamic pmf) on this rank under ``mesh`` and
    unmeshed, in turns (unmeshed, meshed, meshed, unmeshed): the rows and
    streams bit for bit, peak memory of each, queries/s of each batch, and
    the launches of the first meshed batch. Returns the report."""
    import os

    import torch

    from vectorizedbayesiannetwork_torch.ops import sweep

    qs = lq[:B_M3]
    cat.set_inference_method("likelihood_weighting", n_samples=S_STACKED,
                             dynamic_masks=True)
    os.environ["VBN_DISCRETE_SCAN"] = "always"
    rep = {"qps": {"unmeshed": [], "meshed": []},
           "max_memory_allocated_bytes": {}}
    try:
        rows, streams = {}, {}
        for i, m in enumerate((None, mesh, mesh, None)):
            tag = "meshed" if m is not None else "unmeshed"
            cat.set_mesh(m)
            cat._keys.set_state(900)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            sweep.TRACES.update(sharded=0, whole=0)
            t0 = time.perf_counter()
            pmf, _ = cat.infer_posterior_pmf(qs, n_classes=4, pad_bucket=B_M3)
            rep["qps"][tag].append(B_M3 / (time.perf_counter() - t0))
            rep["max_memory_allocated_bytes"].setdefault(tag, []).append(
                torch.cuda.max_memory_allocated())
            if i == 1:
                rep["launches"] = read_launches({"uniforms": SOME})
                rep["traces"] = dict(sweep.TRACES)
            rows.setdefault(tag, pmf)
            if i < 2:
                cat._keys.set_state(901)
                w, s = cat.infer_posterior_many(qs)[0]
                streams[tag] = (w.cpu().numpy(), s.cpu().numpy())
        from vectorizedbayesiannetwork_torch.core import rng

        full = rng.CHUNK_BYTES
        rng.CHUNK_BYTES = 1  # one node a launch: the parent commit's draws
        try:
            cat.set_mesh(None)
            cat._keys.set_state(900)
            reset_launches()
            pmf, _ = cat.infer_posterior_pmf(qs, n_classes=4, pad_bucket=B_M3)
            rep["launches_one_node_a_launch"] = read_launches(
                {"uniforms": SOME})
        finally:
            rng.CHUNK_BYTES = full
        rep["rows_equal_one_node_a_launch"] = bool(np.array_equal(
            pmf, rows["unmeshed"]))
        rep["rows_equal"] = bool(np.array_equal(rows["meshed"],
                                                rows["unmeshed"]))
        rep["streams_equal"] = all(
            np.array_equal(a, b) for a, b in zip(streams["meshed"],
                                                 streams["unmeshed"]))
    finally:
        os.environ.pop("VBN_DISCRETE_SCAN", None)
        cat.set_mesh(None)
    return rep


def check_m3(tag, rep, n_particle):
    """(m3)'s limits: rows and streams equal, the sweep sharded over a
    mesh of more than one rank, and a rank's peak memory under the
    unmeshed one's."""
    log("mesh_m3", mesh=tag, **rep)
    if not (rep["rows_equal"] and rep["streams_equal"]
            and rep["rows_equal_one_node_a_launch"]):
        raise AssertionError(f"m3 {tag}: meshed != unmeshed")
    if n_particle > 1 and rep["traces"]["sharded"] < 1:
        raise AssertionError(f"m3 {tag}: the sweep did not run sharded")
    mem = rep["max_memory_allocated_bytes"]
    if n_particle > 1 and max(mem["meshed"]) >= min(mem["unmeshed"]):
        raise AssertionError(f"m3 {tag}: meshed peak memory {mem}")


# ---------------------------------------------------------------------------
# Phase 26: the ('data', 'particle') mesh over torch.distributed
# ---------------------------------------------------------------------------

M2_MESHES = ((1, 2), (2, 1))  # (n_data, n_particle) of the two ranks
M2_TIMEOUT_S = 600  # the ranks' deadline; a hang fails the phase
M2_WINDOWS = 3  # q/s windows a rank times, best of
FIT_ROWS = 1 << 20  # rows of the data-parallel fit steps


def fit_rows(seed=0):
    """(parents [n, 2], x [n, 1]) float32, n = FIT_ROWS: x = 0.5 p0 -
    0.2 p1 + 0.05 noise (``tests/test_sharding.py``'s fit data)."""
    n = FIT_ROWS
    g = np.random.default_rng(seed)
    parents = g.normal(size=(n, 2)).astype(np.float32)
    x = (parents @ np.array([[0.5], [-0.2]], np.float32)
         + 0.05 * g.normal(size=(n, 1)).astype(np.float32))
    return parents, x


def fit_steps(mesh, net0):
    """(ridge fit, the net after one ``gaussian_nn`` Adam step from
    ``net0``), each on this rank's rows of ``fit_rows()``."""
    from vectorizedbayesiannetwork_torch import CPD_REGISTRY
    from vectorizedbayesiannetwork_torch.parallel.train import (
        gaussian_nn_dp_step,
        linear_gaussian_fit_step,
        shard_rows,
    )

    p, x = shard_rows(mesh, *fit_rows())
    fit = linear_gaussian_fit_step(mesh, p, x)
    cpd = CPD_REGISTRY["gaussian_nn"](2, 1, seed=0, hidden_dims=[8])
    net1, _opt = gaussian_nn_dp_step(mesh, cpd, net0, None, p, x)
    return fit, net1


def mesh_m1(bn, asia_vbn, lg_vbn, phase4):
    """(m1) phase 4's main path under a one-rank NCCL mesh in this process:
    ``initialize_distributed()``, ``make_mesh()``, ``set_mesh`` on the
    phase-2 models, the asia LW pmf and flagship MCM moments at B=1024,
    S=2^20 through the public entry points (launches read around each
    call), held to phase 4's limits; q/s by phase 5's windows, unmeshed
    and meshed in turns; then
    ``set_mesh(None)`` serves phase 4's rows again, bit for bit, at their
    key counters. Returns (the mesh, the launches)."""
    import torch.distributed as dist

    from vectorizedbayesiannetwork_torch.parallel import (
        initialize_distributed,
        make_mesh,
        mesh_signature,
    )

    initialize_distributed()
    mesh = make_mesh(device_type=asia_vbn.device.type)
    qa, ql = asia_query(B_MAIN), flagship_query(B_MAIN)
    asia_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    lg_vbn.set_inference_method("monte_carlo_marginalization", n_samples=S_MAIN)
    for v in (asia_vbn, lg_vbn):
        v.set_mesh(mesh)
    reset_launches()
    pmf, _ = asia_vbn.infer_posterior_pmf([qa], n_classes=2)
    launches = read_launches({"categorical": 1})
    reset_launches()
    mom, _ = lg_vbn.infer_posterior_moments([ql])
    launches["lg"] = read_launches({"lg": 1})["lg"]
    paths = (asia_vbn._last_summary_path, lg_vbn._last_summary_path)
    if paths != ("fused", "fused"):
        raise AssertionError(f"m1 summary paths {paths} != fused")
    main_path_accuracy("mesh_m1_accuracy", bn, asia_vbn, lg_vbn, pmf, mom)
    qps = {}  # unmeshed, meshed, meshed, unmeshed: what the mesh costs
    for m in (None, mesh, mesh, None):
        for v in (asia_vbn, lg_vbn):
            v.set_mesh(m)
        for tag, call in (
                ("asia_lw_pmf", lambda: asia_vbn.infer_posterior_pmf(
                    [qa] * REPS, n_classes=2)),
                ("flagship_mcm_moments", lambda: lg_vbn.infer_posterior_moments(
                    [ql] * REPS))):
            best, _w = end_to_end_qps(call, B_MAIN)
            qps.setdefault(tag, {}).setdefault(
                "meshed" if m is not None else "unmeshed", []).append(best)
    for v in (asia_vbn, lg_vbn):
        v.set_mesh(None)
    again = {}
    for tag, v, call in (
            ("asia", asia_vbn,
             lambda: asia_vbn.infer_posterior_pmf([qa], n_classes=2)[0]),
            ("flagship", lg_vbn,
             lambda: lg_vbn.infer_posterior_moments([ql])[0])):
        counter, rows = phase4[tag]
        v._keys.set_state(counter)
        again[tag] = bool(np.array_equal(call(), rows))
    log("mesh_m1", backend=dist.get_backend(), mesh=mesh_signature(mesh),
        launches=launches, paths=paths, qps_in_turns=qps,
        unmeshed_rows_again=again)
    if not all(again.values()):
        raise AssertionError(f"set_mesh(None) served other rows: {again}")
    return mesh, launches


def m2_fed_uniforms(mesh, models, link_qs, gauss_qs):
    """On a (1, n) mesh, each kernel path fed external uniforms: each
    rank's meshed call gets its own block of [B_CHECK, N or 2N, S_CHECK /
    n]; rank 0 also launches the kernel once unmeshed on the blocks
    concatenated along the particles. The streams must be equal and the
    combined reductions within ``check_outputs``' rtol (pmf 2e-4, moments
    2e-3) of that launch's, the shifts equal. Returns rank 0's errors."""
    import torch
    import torch.distributed as dist

    from vectorizedbayesiannetwork_torch.core.plan import (
        get_plan,
        pack_fixed_values,
    )
    from vectorizedbayesiannetwork_torch.ops.sweep import make_fused_sweep_fn
    from vectorizedbayesiannetwork_torch.ops.sweep_scan import make_scan_sweep_fn
    from vectorizedbayesiannetwork_torch.parallel.mesh import (
        mesh_coords,
        mesh_shape,
    )

    npart, pi = mesh_shape(mesh)[1], mesh_coords(mesh)[1]
    dev = models["asia"].device
    cases = []
    for name, vbn, query, lg, wants in (
            ("vbn_cat_sweep", models["asia"], asia_query(B_CHECK), False,
             [("logw", "lpt"), ("pmf_logw",)]),
            ("vbn_lg_sweep", models["flagship"], flagship_query(B_CHECK), True,
             [("logw", "lpt"), ("mom_lpt",)])):
        q = vbn._normalize_query(query)
        plan = get_plan(vbn, q)
        cpds = tuple(vbn.cpd_spec(n) for n in plan.topo_order)
        params = tuple(vbn.params[n] for n in plan.topo_order)
        fixed = torch.as_tensor(pack_fixed_values(q, plan, B_CHECK,
                                                  clamp_obs=not lg),
                                device=vbn.device)
        for want in wants:
            meshed = make_fused_sweep_fn(plan, cpds, S_CHECK, want, mesh=mesh)
            whole = make_fused_sweep_fn(plan, cpds, S_CHECK, want)
            cases.append((name, want, plan.n_nodes * (1 + lg), lg,
                          lambda u, raw=meshed, p=params, f=fixed: raw(p, 0, f, u_ext=u),
                          lambda u, raw=whole, p=params, f=fixed: raw(p, 0, f, u_ext=u)))
    for name, vbn, queries, lg, wants in (
            ("vbn_cat_scan", models["link"], link_qs[:B_CHECK], False,
             [("logw", "tgt"), ("pmf_logw",)]),
            ("vbn_lg_scan", models["gauss"], gauss_qs[:B_CHECK], True,
             [("logw", "tgt"), ("mom_logw",)])):
        plan, cpds, params, *rows = scan_inputs(
            vbn, [as_query(t, ev) for t, ev in queries])
        for want in wants:
            meshed = make_scan_sweep_fn(plan, cpds, S_CHECK, want, mesh=mesh)
            whole = make_scan_sweep_fn(plan, cpds, S_CHECK, want)
            cases.append((name, want, plan.n_nodes * (1 + lg), lg,
                          lambda u, raw=meshed, p=params, r=rows: raw(p, 0, *r, u_ext=u),
                          lambda u, raw=whole, p=params, r=rows: raw(p, 0, *r, u_ext=u)))
    errs = {}
    for i, (name, want, n_rows, lg, meshed, whole) in enumerate(cases):
        blocks = []
        for p in range(npart):
            g = torch.Generator(device=dev).manual_seed(1000 * i + p)
            blocks.append(torch.rand((B_CHECK, n_rows, S_CHECK // npart),
                                     generator=g, device=dev)
                          .clamp_(1e-6, 1.0 - 1e-6))
        got = meshed(blocks[pi])
        if dist.get_rank() == 0:
            ref = whole(torch.cat(blocks, dim=2))
            errs[f"{name}:{','.join(want)}"] = check_outputs(
                f"m2 fed {name} {want}", got, ref, want, tgt_atol=0, lp_atol=0)
    return errs


def m2_serve(mesh, models, link_qs, gauss_qs, net0):
    """One mesh's workloads on this rank: the main path, the link-scale and
    gauss107 dynamic cells, RIS systematic and multinomial on the flagship
    diagnosis query (ESS threshold 0.99), the fit steps and the q/s
    windows. Returns (report, arrays)."""
    import torch.distributed as dist

    from vectorizedbayesiannetwork_torch.parallel.mesh import mesh_shape

    nd, npart = mesh_shape(mesh)
    asia, lg, link, gauss = (models[k] for k in ("asia", "flagship", "link",
                                                   "gauss"))
    asia.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    lg.set_inference_method("monte_carlo_marginalization", n_samples=S_MAIN)
    for v in (link, gauss):
        v.set_inference_method("likelihood_weighting", n_samples=S_MAIN,
                               dynamic_masks=True)
    for v in models.values():
        v.set_mesh(mesh)
    rep, arr = {"launches": {}}, {}

    def served(tag, expect, call):
        reset_launches()
        out = call()
        rep["launches"][tag] = {k: v for k, v in read_launches(expect).items()
                                if v}
        return out

    qa, ql = asia_query(B_MAIN), flagship_query(B_MAIN)
    arr["asia_pmf"] = served("asia", {"categorical": 1}, lambda: asia.infer_posterior_pmf(
        [qa], n_classes=2)[0])
    arr["flagship_mom"] = served("flagship", {"lg": 1}, lambda: lg.infer_posterior_moments(
        [ql])[0])
    arr["link_pmf"], rep["link_spans"] = served(
        "link", {"categorical_scan": 1}, lambda: link.infer_posterior_pmf(
            [as_query(t, ev) for t, ev in link_qs], n_classes=4,
            pad_bucket=N_DYN))
    arr["gauss_mom"], rep["gauss_spans"] = served(
        "gauss", {"lg_scan": 1}, lambda: gauss.infer_posterior_moments(
            [as_query(t, ev) for t, ev in gauss_qs], pad_bucket=N_DYN))
    q = flagship_diag_query()
    for method, cumsums in (("systematic", 1), ("multinomial", 2)):
        lg.set_inference_method("resampled_importance_sampling",
                                n_samples=S_RIS, ess_threshold=0.99,
                                resample_method=method)
        # one resampling event (x2): the cumsums, and a vbn_spg a ring step
        w, samples = served(f"ris_{method}", {"cumsum": cumsums, "spg": npart,
                                              "uniforms": SOME},
                            lambda: lg.infer_posterior(q))
        rep[f"ris_{method}"] = dict(
            diag_accuracy(lg, q, w, samples),
            resampled=lg._inference._last_resampled,
            ess=lg._inference._last_ess.tolist())
    lg.set_inference_method("monte_carlo_marginalization", n_samples=S_MAIN)
    fit, net1 = fit_steps(mesh, net0)
    from vectorizedbayesiannetwork_torch.vbn import _flatten_params

    arr.update({f"fit_{k}": v for k, v in fit.items()})
    arr.update({f"net1/{k}": v for k, v in _flatten_params(net1).items()})
    qps = {}
    for tag, call in (
            ("asia_lw_pmf", lambda: asia.infer_posterior_pmf([qa] * REPS,
                                                            n_classes=2)),
            ("flagship_mcm_moments", lambda: lg.infer_posterior_moments(
                [ql] * REPS))):
        call()
        best = 0.0
        for _ in range(M2_WINDOWS):
            dist.barrier()
            t0 = time.perf_counter()
            call()  # fetches the rows: synchronous
            best = max(best, B_MAIN * REPS / (time.perf_counter() - t0))
        qps[tag] = best
    rep["rank_qps"] = qps
    if nd == 1 and npart > 1:
        rep["fed_uniforms_max_abs_err"] = m2_fed_uniforms(mesh, models,
                                                          link_qs, gauss_qs)
    rep["chains"], chain_arr = m2_chains(mesh, models)
    arr.update(chain_arr)
    for v in models.values():
        v.set_mesh(None)
    return rep, arr


M2_CHAINS = (  # (case, model, sampler, settings): 8 rows of 8 chains
    ("gibbs_tables", "asia", "gibbs", {"burn_in": 10, "n_steps": 2}),
    ("gibbs_lg", "flagship", "gibbs", {"burn_in": 10, "n_steps": 2}),
    ("hmc_fixed", "flagship", "hmc", {"burn_in": 10, "step_size": 0.2}),
    ("hmc_adapted", "flagship", "hmc", {"burn_in": 10, "step_size": 0.2,
                                        "adapt_step_size": True}),
    ("nuts_fixed", "flagship", "nuts", {"burn_in": 3, "step_size": 0.2,
                                        "max_tree_depth": 4}),
    ("nuts_adapted", "flagship", "nuts", {
        "burn_in": 3, "step_size": 5.0, "max_tree_depth": 4,
        "adapt_step_size": True}),
    ("hmc_refused", "flagship", "hmc", {"burn_in": 5, "n_chains": 3}),
)
M2_REFUSED_ROWS = 3  # the refused case's rows: 3 rows of 3 chains split
# over neither axis of a two-rank mesh


def m2_chains(mesh, models):
    """The chain samplers under ``mesh`` against unmeshed, each from key
    counter 900 (`M2_CHAINS`; 8 rows of 8 chains split over either mesh;
    3 rows of 3 chains split over neither and run whole): meshed
    equals unmeshed bit for bit on this rank, and the samplers' ``CHAINS``
    counts say sharded (whole for the refused case). Returns (report,
    arrays: the meshed draws, which the parent holds equal across
    ranks)."""
    import torch

    from vectorizedbayesiannetwork_torch.sampling import chains

    qs = {"flagship": flagship_diag_query(),
          "asia": {"target": "lung", "evidence": {
              "xray": np.tile([[1.0], [0.0]], (4, 1)).astype(np.float32),
              "dysp": np.repeat([[1.0], [0.0]], 4, 0).astype(np.float32)}}}
    rep, arr = {}, {}
    for case, tag, name, kw in M2_CHAINS:
        vbn = models[tag]
        kw = dict({"n_samples": 64, "n_chains": 8}, **kw)
        refused = case.endswith("_refused")
        q = flagship_diag_query(M2_REFUSED_ROWS) if refused else qs[tag]
        vbn.set_sampling_method(name)
        outs = []
        for m in (None, mesh):
            vbn.set_mesh(m)
            chains.CHAINS.update(sharded=0, whole=0)
            vbn._keys.set_state(900)
            t0 = time.perf_counter()
            outs.append(vbn.sample(q, **kw))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        vbn.set_mesh(mesh)
        counts = dict(chains.CHAINS)
        equal = bool(torch.equal(outs[0], outs[1]))
        rep[case] = {"meshed_equals_unmeshed": equal, "counts": counts,
                     "meshed_seconds": secs}
        if not equal or counts != ({"sharded": 0, "whole": 1} if refused
                                   else {"sharded": 1, "whole": 0}):
            raise AssertionError(f"m2 chains {case}: meshed != unmeshed "
                                 f"({equal}) or routed {counts}")
        arr[f"chains_{case}"] = outs[1]
    return rep, arr


def m2_rank(rank, world, tmp):
    """One rank of (m2): joins a gloo group with the other rank on the one
    card, loads the saved models with ``map_location="cuda"`` and the
    kernels the parent built, serves every mesh of M2_MESHES, and writes
    ``m2_<rank>.json`` / ``.npz`` into ``tmp``."""
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from vectorizedbayesiannetwork_torch import VBN
    from vectorizedbayesiannetwork_torch.ops import _build
    from vectorizedbayesiannetwork_torch.parallel import (
        initialize_distributed,
        make_mesh,
        mesh_signature,
    )
    from vectorizedbayesiannetwork_torch.vbn import params_from_numpy

    tmp = Path(tmp)
    meta = json.loads((tmp / "queries.json").read_text())
    dev = torch.device(meta["device"])
    if dev.type == "cuda":
        missing = [n for n in _build.SOURCES
                   if not _build.library_path(n).exists()]
        if missing:
            raise RuntimeError(f"rank {rank}: kernels not built by the parent: "
                               f"{missing}")
        torch.cuda.set_device(0)
    initialize_distributed(init_method=f"file://{tmp}/group", world_size=world,
                           rank=rank, backend="gloo", timeout_s=300)
    try:
        models = {tag: VBN.load(str(tmp / tag), map_location=dev)
                  for tag in ("asia", "flagship", "link", "gauss")}
        with np.load(tmp / "net0.npz") as f:
            net0 = params_from_numpy({k: f[k] for k in f.files}, dev)
        report, arrays = {}, {}
        for nd, npart in M2_MESHES:
            t0 = time.perf_counter()
            mesh = make_mesh(nd, npart, device_type=dev.type)
            rep, arr = m2_serve(mesh, models, meta["link"], meta["gauss"],
                                net0)
            tag = f"{nd}x{npart}"
            report[tag] = dict(rep, mesh=mesh_signature(mesh),
                               seconds=time.perf_counter() - t0)
            arrays.update({f"{tag}:{k}": v.detach().cpu().numpy()
                           if isinstance(v, torch.Tensor) else np.asarray(v)
                           for k, v in arr.items()})
        # (m3) t3's stacked form sharded over 'particle' on (1, 2)
        cat = VBN.load(str(tmp / "t3"), map_location=dev)
        m3 = m3_serve(make_mesh(1, 2, device_type=dev.type), cat,
                      [as_query(t, ev) for t, ev in meta["t3"]])
        report["m3"] = m3
        (tmp / f"m2_{rank}.json").write_text(json.dumps(report))
        np.savez(tmp / f"m2_{rank}.npz", **arrays)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, tmp, timeout_s):
    """``fn(rank, world, tmp)`` in ``world`` spawned processes; raises on a
    rank's error or exit, and at the deadline (killing every rank)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, str(tmp)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"mesh ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(30)


def mesh_m2(bn, asia_vbn, lg_vbn, link, gauss, mesh1):
    """(m2) two ranks on the one card over gloo, the meshes of M2_MESHES.
    The models of phases 2 and 7 go to the ranks by ``VBN.save``; the
    ranks' rows are held here to phase 4's and phase 7's limits, their fit
    steps to the one-rank steps on m1's mesh (ridge fit 1e-4, the Adam step
    1e-5 of the params' scale). Returns the launches summed over ranks and
    meshes."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from vectorizedbayesiannetwork_torch import CPD_REGISTRY
    from vectorizedbayesiannetwork_torch.ops import _build
    from vectorizedbayesiannetwork_torch.vbn import _flatten_params

    link_bn, link_vbn, link_qs = link
    _gbn, gauss_vbn, gauss_qs = gauss
    t0 = time.perf_counter()
    dev = asia_vbn.device
    net0 = CPD_REGISTRY["gaussian_nn"](2, 1, seed=0, hidden_dims=[8]).init(
        dev, gen=torch.Generator(device=dev).manual_seed(0))["net"]
    ref_fit, ref_net = fit_steps(mesh1, net0)
    ref_net = _flatten_params(ref_net)
    tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR.parent))
    try:
        cat, _lq, t3_qs = KEPT["t3_cat"]
        for tag, v in (("asia", asia_vbn), ("flagship", lg_vbn),
                       ("link", link_vbn), ("gauss", gauss_vbn), ("t3", cat)):
            v.save(str(tmp / tag))
        np.savez(tmp / "net0.npz", **_flatten_params(net0))
        (tmp / "queries.json").write_text(json.dumps(
            {"link": link_qs, "gauss": gauss_qs, "device": str(dev),
             "t3": t3_qs[:B_M3]}))
        run_ranks(m2_rank, 2, tmp, M2_TIMEOUT_S)
        reports = [json.loads((tmp / f"m2_{r}.json").read_text())
                   for r in range(2)]
        arrays = []
        for r in range(2):
            with np.load(tmp / f"m2_{r}.npz") as f:
                arrays.append({k: f[k] for k in f.files})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, v in arrays[0].items():
        if not np.array_equal(arrays[1][k], v):
            raise AssertionError(f"m2: the two ranks returned other {k}")
    gts = link_exact(link_bn, link_vbn, link_qs)
    total = {}
    for nd, npart in M2_MESHES:
        tag = f"{nd}x{npart}"
        a = {k.split(":", 1)[1]: v for k, v in arrays[0].items()
             if k.startswith(tag + ":")}
        acc = main_path_accuracy(f"mesh_m2_{tag}_accuracy", bn, asia_vbn,
                                 lg_vbn, a["asia_pmf"], a["flagship_mom"])
        lacc = link_accuracy(link_bn, link_vbn, link_qs, a["link_pmf"],
                             reports[0][tag]["link_spans"], gts=gts)
        gacc = gauss_accuracy(gauss_vbn, gauss_qs, a["gauss_mom"],
                              reports[0][tag]["gauss_spans"])
        fit_err = max(float(np.abs(a[f"fit_{k}"] - ref_fit[k].cpu().numpy()).max())
                      for k in ("weight", "bias", "var"))
        scale = max(1.0, max(float(np.abs(v).max()) for v in ref_net.values()))
        nn_err = max(float(np.abs(a[f"net1/{k}"] - v).max()) / scale
                     for k, v in ref_net.items())
        ris = {m: reports[0][tag][f"ris_{m}"]
               for m in ("systematic", "multinomial")}
        rank_qps = [rep[tag]["rank_qps"] for rep in reports]
        log("mesh_m2_chains", mesh=tag, ranks=[rep[tag]["chains"]
                                              for rep in reports])
        log("mesh_m2", mesh=tag, ranks_share_one_card=True, backend="gloo",
            launches_per_rank=[rep[tag]["launches"] for rep in reports],
            link=lacc, lg=gacc, ris=ris, fit_max_abs_err=fit_err,
            nn_step_max_err_of_scale=nn_err,
            fed_uniforms_max_abs_err=reports[0][tag].get(
                "fed_uniforms_max_abs_err"),
            rank_qps_two_ranks_one_card=rank_qps,
            total_qps_two_ranks_one_card={
                k: min(q[k] for q in rank_qps) for k in rank_qps[0]},
            rank_seconds=[rep[tag]["seconds"] for rep in reports], **acc)
        if lacc["kl_median"] > 2e-3:
            raise AssertionError(f"m2 {tag}: link median KL {lacc['kl_median']}")
        if gacc["dmean_over_std"] > 0.05 or gacc["dstd_over_std"] > 0.05:
            raise AssertionError(f"m2 {tag}: gauss107 moments off: {gacc}")
        for m, r in ris.items():
            if not r["resampled"] or r["dmean_over_std"] > 0.05 or \
                    r["dstd_over_std"] > 0.05:
                raise AssertionError(f"m2 {tag}: RIS {m} off the closed form: {r}")
        if fit_err > 1e-4 or nn_err > 1e-5:
            raise AssertionError(f"m2 {tag}: fit steps off the one-rank "
                                 f"steps: {fit_err}, {nn_err}")
        if npart > 1 and nd == 1 and not reports[0][tag].get(
                "fed_uniforms_max_abs_err"):
            raise AssertionError(f"m2 {tag}: the fed-uniform check did not run")
        for rep in reports:
            for got in rep[tag]["launches"].values():
                for k, v in got.items():
                    total[k] = total.get(k, 0) + v
    for r, rep in enumerate(reports):
        check_m3(f"1x2 gloo rank {r}", rep["m3"], 2)
        for k, v in rep["m3"]["launches"].items():
            total[k] = total.get(k, 0) + v
    log("mesh_m2_done", seconds=time.perf_counter() - t0, launches=total)
    return total


def serve_mesh(bn, asia_vbn, lg_vbn, phase4, link, gauss):
    """Phase 26: (m1), then (m2); returns each one's launches."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    mesh1, m1 = mesh_m1(bn, asia_vbn, lg_vbn, phase4)
    try:
        cat, lq, _ = KEPT["t3_cat"]
        m3 = m3_serve(mesh1, cat, lq)
        check_m3("1x1 nccl", m3, 1)
        m2 = mesh_m2(bn, asia_vbn, lg_vbn, link, gauss, mesh1)
    finally:
        dist.destroy_process_group()
    log("mesh_done", seconds=time.perf_counter() - t0)
    return {"m1": m1, "m3": m3["launches"], "m2": m2}


def load_parent(root, name="vbn_parent"):
    """The port package of another checkout at ``root`` (for example the
    parent commit's, unpacked with ``git archive``), imported under
    ``name``; it builds its own kernels into ``root/build/kernels``."""
    import importlib
    import importlib.util
    from pathlib import Path

    init = Path(root).resolve() / "vectorizedbayesiannetwork_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for sub in ("defaults", "ops.sweep", "ops.rng", "ops._build"):
        if (init.parent / (sub.replace(".", "/") + ".py")).exists():
            importlib.import_module(f"{name}.{sub}")
    return mod


SAMPLER_ROUNDS = 10  # compare_samplers: rounds of every build a metric
T3_ROUNDS = 5  # and of (t3)'s LG per-node loop


def sampler_runs():
    """(metric, model, sampler, query, settings, units a call, unit) of the
    chain samplers at phases s2-s4's sizes."""
    _, w2, _ = kde_flagship_queries()
    q3 = {"target": "x2", "evidence": {"x0": [[0.5]]}}
    q4 = {"target": "x0", "evidence": {"x2": [[0.5]]}}
    nuts = dict(S4, max_tree_depth=S4_NUTS_DEPTH)
    lg_tr = S4["burn_in"] + -(-S4["n_samples"] // S4["n_chains"])
    return (
        ("s2_gibbs_kde", "kde", "gibbs", w2, S2, B_KDE * S2["n_samples"],
         "draw"),
        ("s3_gibbs_lg_hoisted", "lg", "gibbs", q3, S3,
         S3["burn_in"] + S3["n_samples"] * S3["n_steps"], "step"),
        ("s4_hmc_lg", "lg", "hmc", q4, S4, lg_tr, "transition"),
        ("s4_nuts_lg", "lg", "nuts", q4, nuts, lg_tr, "transition"),
        ("s4_hmc_kde", "kde", "hmc", w2, S4_KDE,
         S4_KDE["burn_in"] + -(-S4_KDE["n_samples"] // S4_KDE["n_chains"]),
         "transition"),
    )


def rounds_report(ms, units, order):
    """Each build's ms of a call over the rounds: the list, and the median,
    min and max a unit; each other build's median over this one's."""
    rep = {}
    for tag in order:
        got = np.asarray(ms[tag], np.float64) / units
        rep[tag] = {"ms_a_call": ms[tag], "median_ms": float(np.median(got)),
                    "min_ms": float(got.min()), "max_ms": float(got.max())}
    for tag in order:
        if tag != "this":
            rep[f"this_over_{tag}"] = (rep["this"]["median_ms"]
                                       / rep[tag]["median_ms"])
    return rep


def compare_samplers(roots, rounds=SAMPLER_ROUNDS, t3_rounds=T3_ROUNDS,
                     t3=("parent",)):
    """The chain samplers at phases s2-s4's sizes (``sampler_runs``) on
    this checkout's package and on other checkouts' (``roots``: tag ->
    directory, each imported by ``load_parent`` as ``vbn_<tag>``), in one
    process on one card: ``rounds`` rounds, each running every build once a
    metric, this build first on even rounds and last on odd ones (a round
    pair is this, others, others, this). Then (t3)'s LG per-node loop (the
    2048-node LG network, 96 queries, S=2^14, ``VBN_DISCRETE_SCAN=never``)
    for the builds in ``t3`` and this one, ``t3_rounds`` rounds. Logs
    ``compare_samplers`` lines: each build's ms of a call, its median, min
    and max ms a unit (draw, step, transition, batch) and this build's
    median over each other's. Run alone after a build: ``python3 -c
    "import chip_smoke as c; c.compare_samplers({'parent': 'DIR'})"``."""
    import os

    import torch

    from benchmarking.gaussian_bn import random_gaussian
    from vectorizedbayesiannetwork_torch import VBN, defaults

    builds = {"this": (VBN, defaults)}
    for tag, root in roots.items():
        mod = load_parent(root, name=f"vbn_{tag}")
        builds[tag] = (mod.VBN, mod.defaults)
    order = list(builds)
    runs = sampler_runs()
    calls = {}
    t0 = time.perf_counter()
    for tag, (vbn_cls, dfl) in builds.items():
        models = {"kde": fit_kde(vbn_cls, dfl, [("x0", "x2"), ("x1", "x2")],
                                 flagship_data()),
                  "lg": fit_flagship(vbn_cls, dfl)}
        for metric, model, name, q, kw, _units, _unit in runs:
            def call(v=models[model], name=name, q=q, kw=kw):
                v.set_sampling_method(name)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                v.sample(q, **kw)
                torch.cuda.synchronize()
                return 1e3 * (time.perf_counter() - t1)

            models[model].set_sampling_method(name)
            models[model].sample(q, **dict(kw, burn_in=2,
                                           n_samples=kw.get("n_chains", 8)))
            calls[tag, metric] = call
    log("compare_samplers", builds={t: str(roots.get(t, ".")) for t in order},
        setup_seconds=time.perf_counter() - t0)
    ms = {k: [] for k in calls}
    for i in range(rounds):
        for metric, *_ in runs:
            for tag in (order if i % 2 == 0 else order[::-1]):
                ms[tag, metric].append(calls[tag, metric]())
    for metric, _m, _n, _q, kw, units, unit in runs:
        log("compare_samplers", metric=metric, unit=unit, units=units,
            rounds=rounds, **rounds_report(
                {t: ms[t, metric] for t in order}, units, order))

    t3_order = ["this"] + [t for t in order if t in t3]
    gbn = random_gaussian(N_STACKED, seed=0)
    gq = [as_query(t, ev) for t, ev in gauss_queries(gbn)]
    serve = {}
    for tag in t3_order:
        vbn_cls, dfl = builds[tag]
        gauss = fit_gaussian(vbn_cls, dfl, gbn)
        gauss.set_inference_method("likelihood_weighting",
                                   n_samples=S_STACKED, dynamic_masks=True)

        def batch(v=gauss):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            v.infer_posterior_moments(gq, pad_bucket=N_DYN)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t1)

        serve[tag] = batch
    os.environ["VBN_DISCRETE_SCAN"] = "never"
    try:
        for tag in t3_order:
            serve[tag]()
        t3_ms = {t: [] for t in t3_order}
        for i in range(t3_rounds):
            for tag in (t3_order if i % 2 == 0 else t3_order[::-1]):
                t3_ms[tag].append(serve[tag]())
    finally:
        os.environ.pop("VBN_DISCRETE_SCAN", None)
    log("compare_samplers", metric="t3_lg_per_node_loop", unit="batch",
        units=1, queries=N_DYN, rounds=t3_rounds,
        **rounds_report(t3_ms, 1, t3_order))


def compare_builds(root):
    """The kernel this checkout redesigned beside another checkout's build
    of it (``--parent root``), in one process on one card, in turns
    (other, this, this, other): ``vbn_uniforms`` at W1's [8, 2^20] (one
    node) and for 64 nodes at t3's [96, 2^14] (a build that draws one node
    a launch is timed over its 64 launches), each build's values held bit
    for bit against the other's, device ms (``graph_ms``) and the
    wrapper's ms (CUDA events). First, queries/s served by each package end
    to end (moments held within 0.05 sd of the other build's): flagship
    RIS systematic and multinomial, W1's KDE LW and flagship IS (a level
    group of the two roots here). Run alone after a build: ``python3 -c
    "import chip_smoke as c; c.compare_builds('DIR')"``."""
    import torch

    from vectorizedbayesiannetwork_torch import VBN, defaults

    par = load_parent(root)
    prng = par.ops.rng
    log("compare_builds", parent=str(root),
        build_seconds=par.ops._build.build_all(["rng", "kde"]))

    def turns(metric, other, this):
        got = [other(), this(), this(), other()]
        log("compare_builds", metric=metric, parent=[got[0], got[3]],
            this=[got[1], got[2]])

    # end to end: flagship RIS, systematic and multinomial, on each package
    qr = flagship_diag_query()
    serve, rows = {}, {}
    for tag, mod in (("parent", par), ("this", None)):
        vbn_cls = mod.VBN if mod else VBN
        dfl = mod.defaults if mod else defaults
        rows[tag], serve[tag] = {}, {}
        for method in ("systematic", "multinomial"):
            ris = fit_flagship(vbn_cls, dfl)
            ris.set_inference_method("resampled_importance_sampling",
                                     n_samples=S_RIS, resample_method=method)
            w, smp = ris.infer_posterior(qr)
            stats = ris._posterior_stats(w, smp.float())
            rows[tag][f"flagship_ris_{method}"] = np.stack(
                [stats[k].cpu().numpy()[:, 0] for k in ("mean", "std")], 1)
            serve[tag][f"flagship_ris_{method}"] = (
                lambda ris=ris: method_qps(ris, qr, B_RIS)[0])
        w1 = kde_flagship_queries()[0]
        kde = fit_kde(vbn_cls, dfl, [("x0", "x2"), ("x1", "x2")],
                      flagship_data())
        kde.set_inference_method("likelihood_weighting", n_samples=S_KDE)
        rows[tag]["w1_kde_flagship_lw"] = kde.infer_posterior_moments([w1])[0]
        serve[tag]["w1_kde_flagship_lw"] = lambda kde=kde, w1=w1: dynamic_qps(
            lambda: kde.infer_posterior_moments([w1]), B_KDE)[0]
        is_ = fit_flagship(vbn_cls, dfl)
        is_.set_inference_method("importance_sampling", n_samples=S_RIS)
        w, smp = is_.infer_posterior(qr)
        stats = is_._posterior_stats(w, smp.float())
        rows[tag]["flagship_is"] = np.stack([stats[k].cpu().numpy()[:, 0]
                                             for k in ("mean", "std")], 1)
        serve[tag]["flagship_is"] = lambda is_=is_: method_qps(is_, qr,
                                                               B_RIS)[0]
    for name in rows["this"]:
        a, b = rows["parent"][name], rows["this"][name]
        gap = float(np.abs(a - b).max() / np.abs(b[:, 1]).min())
        log("compare_builds", workload=name, moments_gap_over_std=gap)
        if gap > 0.05:
            raise AssertionError(f"{name}: builds' moments differ by {gap} sd")
    for metric in serve["this"]:
        turns(f"{metric}_qps", serve["parent"][metric], serve["this"][metric])

    # vbn_uniforms: one node at W1's shape; 64 nodes at t3's, which the
    # other build may draw one launch a node
    dev = torch.device("cuda")
    from vectorizedbayesiannetwork_torch.ops import rng

    many = hasattr(prng, "stream_values_many")  # else one node a launch
    for name, b, s, nodes in (("w1", B_KDE, S_KDE, [5]),
                              ("t3_64_nodes", N_DYN, S_STACKED,
                               list(range(5, 69)))):
        def other(b=b, s=s, nodes=nodes):
            if many:
                return prng.stream_values_many(STREAM_SEED, b, s, nodes, 1,
                                               device=dev)
            return torch.stack([prng.stream_values(STREAM_SEED, b, s, n, 1,
                                                   device=dev) for n in nodes])

        def this(b=b, s=s, nodes=nodes):
            return rng.stream_values_many(STREAM_SEED, b, s, nodes, 1,
                                          device=dev)

        exact(f"vbn_uniforms {name} between builds", other(), this())
        turns(f"vbn_uniforms_{name}_device_ms",
              lambda f=other: graph_ms(f, 5), lambda f=this: graph_ms(f, 5))
        turns(f"vbn_uniforms_{name}_wrapper_ms",
              lambda f=other: cuda_ms(f, 5), lambda f=this: cuda_ms(f, 5))


def kernel_name(mangled):
    """A kernel's mangled name as ``name<template arguments>``
    (``cat_scan_kernel<1,2,0>``)."""
    k = re.search(r"\d([a-z_]+_kernel)((?:I(?:Li\d+E|Lb[01]E)+E)?)", mangled)
    if not k:
        return mangled
    args = re.findall(r"L[ib](\d+)E", k.group(2))
    return k.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(text):
    """Registers and spills of each entry function in nvcc's ``-Xptxas -v``
    output: [{kernel, registers, spill_stores, spill_loads}], the kernel
    named by ``kernel_name``."""
    out, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "spill_stores": spill[0], "spill_loads": spill[1]})
            name, spill = None, (0, 0)
    return out


SASS_KERNELS = {"sweep": ("cat_sweep_kernel", "lg_sweep_kernel"),
                "sweep_scan": ("cat_scan_kernel", "lg_scan_kernel"),
                "resample": ("cumsum_tile_kernel", "cumsum_kernel",
                             "merge_kernel"),
                "kde": ("kde_direct_kernel", "kde_wide_kernel"),
                "mlp": ("gauss_mlp_kernel",)}
SASS_OPS = ("MUFU", "IMAD", "LOP3", "FFMA", "FMUL", "FADD", "LDS", "STS",
            "LDG", "BRA", "CALL")


def sass_report(lib_path):
    """Static SASS of each kernel in ``lib_path`` (``cuobjdump
    -sass``): per entry function, its instruction count and the counts of
    the opcodes in SASS_OPS (an opcode counts under the first name it
    starts with: IMAD.WIDE is IMAD). A count of code, not of executed
    instructions."""
    from pathlib import Path

    from vectorizedbayesiannetwork_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = {"kernel": kernel_name(m.group(1)), "instructions": 0,
                   **{op: 0 for op in SASS_OPS}}
            out.append(cur)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and cur is not None and m.group(1) != "NOP":
            cur["instructions"] += 1
            op = next((o for o in SASS_OPS if m.group(1).startswith(o)), None)
            if op:
                cur[op] += 1
    return out


MLP_SIZES = (1 << 20, 96 << 20)  # rows: one query at S=2^20; the gnn cell's call
MLP_PLAIN_ROWS = 1 << 22  # rows a call of the plain version
MLP_MIN_SCALE = 1e-4  # the configuration's (defaults.cpd("gaussian_nn"))


def mlp_node(dp, seed, head_shift=0.0):
    """A ``gaussian_nn`` node of widths (32, 32) on the card, its weights
    drawn as a fit starts (``mlp_init``) and its statistics at random;
    ``head_shift`` moves the softplus input's bias."""
    import torch

    from vectorizedbayesiannetwork_torch.models.gaussian_nn import GaussianNNCPD

    gen = torch.Generator().manual_seed(seed)
    cpd = GaussianNNCPD(dp, 1, hidden_dims=(32, 32), min_scale=MLP_MIN_SCALE)
    params = cpd.init("cpu", gen)
    params["stats"] = {
        "mean_x": torch.randn(dp, generator=gen),
        "std_x": 0.5 + torch.rand(dp, generator=gen),
        "mean_y": torch.randn(1, generator=gen),
        "std_y": 0.5 + torch.rand(1, generator=gen),
    }
    params["net"]["layers"][-1]["b"][1] += head_shift
    return cpd, params_to(params, lambda t: t.cuda())


def mlp_gaps(got, want, std_y):
    """(loc gap in units of ``std_y``, scale gap relative)."""
    (gl, gs), (wl, ws) = got, want
    return (float((gl - wl).abs().max()) / std_y,
            float(((gs - ws).abs() / ws).max()))


def mlp_cost(dp, m):
    """(operations, bytes, SFU operations) of ``m`` rows of a forward, by
    ``vbnbench/work/gaussian_nn.py``'s count: each parent read once, loc
    and scale written once, the weights read once."""
    from vbnbench.work import gaussian_nn as work

    f = work.forward(dp, [32, 32])
    nbytes = 4 * (m * (dp + 2) + work.weights(dp, [32, 32]) + 2 * dp + 2)
    return f["ops"] * m, nbytes, f["sfu"] * m


def check_mlp_fused(launches):
    """Phase mlp_fused (see the module note): a kernel line's row."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import mlp_fused
    from vectorizedbayesiannetwork_torch.utils.profiling import MLP

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(24)
    limit, worst, timing = 1e-5, {}, {}
    for dp in (1, 2, 3):
        for m in MLP_SIZES:
            shifts = (0.0, 30.0) if m == MLP_SIZES[0] else (0.0,)
            for shift in shifts:
                cpd, params = mlp_node(dp, 700 + dp, shift)
                net, stats = params["net"], params["stats"]
                std_y = float(stats["std_y"])
                pa = 2.0 * torch.randn((m, dp), device="cuda", generator=gen)
                assert mlp_fused.refusal(pa, net, stats, "relu", "float32") is None
                got = mlp_fused.gauss_mlp(pa, net, stats, MLP_MIN_SCALE)
                with torch.no_grad():
                    want = cpd._denorm_params(params, pa, m)
                torch.cuda.synchronize()
                gaps = mlp_gaps(got, want, std_y)
                rec = {"dp": dp, "rows": m, "head_shift": shift,
                       "loc_gap": gaps[0], "scale_gap": gaps[1]}
                if m == MLP_SIZES[0]:
                    plain = mlp_fused.gauss_mlp_plain(pa, net, stats,
                                                      MLP_MIN_SCALE)
                    rec["plain_loc_gap"], rec["plain_scale_gap"] = mlp_gaps(
                        got, plain, std_y)
                    rec["plain_equal_rows"] = float(
                        ((got[0] == plain[0]) & (got[1] == plain[1]))
                        .float().mean())
                log("mlp_fused_check", **rec, limit=limit)
                held = [k for k in rec if k.endswith("_gap")]
                if any(rec[k] > limit for k in held):
                    raise AssertionError(f"vbn_gauss_mlp past {limit}: {rec}")
                for k in held:
                    worst[k] = max(worst.get(k, 0.0), rec[k])
                del got, want
                if m == MLP_SIZES[1] and shift == 0.0:
                    timing[dp] = mlp_timing(cpd, params, pa)
                del pa
                torch.cuda.empty_cache()

    # the served primitives launch the kernel, and it counts its forwards
    cpd, params = mlp_node(3, 703)
    m = MLP_SIZES[0]
    pa = torch.randn((m, 3), device="cuda", generator=gen)
    before = dict(MLP)
    reset_launches()
    x = cpd._sample_flat(params, gen, pa, m)
    cpd._log_prob_flat(params, x, pa)
    counted = {k: MLP[k] - before[k] for k in MLP}
    counted["launches"] = read_launches({"gauss_mlp": 2})["gauss_mlp"]
    log("mlp_fused_counters", **counted)
    if counted != {"forwards": 2, "rows": 2 * m, "fused": 2,
                   "fused_rows": 2 * m, "launches": 2}:
        raise AssertionError(f"the served forward missed the kernel: {counted}")

    t = timing[3]
    return kernel_row(
        "vbn_gauss_mlp", "none: the JAX package leaves the MLP to XLA "
        "(models/gaussian_nn.py, models/_mlp.py)", launches,
        max(worst.values()), t["ms"], t["plain_ms"], mlp_cost(3, MLP_SIZES[1]),
        source="vectorizedbayesiannetwork_torch/csrc/mlp.cu",
        library_ms=t["library_ms"]) | {
            "by_dp": {dp: {**v, "bound_ms": bound(mlp_cost(dp, MLP_SIZES[1]))[0]}
                      for dp, v in timing.items()},
            "max_gaps": worst}


def mlp_timing(cpd, params, pa):
    """ms of the kernel and of the plain route (CUDA events, a warm-up then
    5 runs each), and of the plain version over the whole batch,
    MLP_PLAIN_ROWS rows a call."""
    import torch

    from vectorizedbayesiannetwork_torch.ops import mlp_fused

    net, stats = params["net"], params["stats"]
    m = pa.shape[0]
    out = {"rows": m}
    with torch.no_grad():
        for key, fn in (
                ("ms", lambda: mlp_fused.gauss_mlp(pa, net, stats,
                                                   MLP_MIN_SCALE)),
                ("library_ms", lambda: cpd._denorm_params(params, pa, m))):
            out[key] = cuda_ms(fn, 5)
            torch.cuda.empty_cache()

        def plain(r0, r1):
            mlp_fused.gauss_mlp_plain(pa[r0:r1], net, stats, MLP_MIN_SCALE)

        def whole():
            for r in range(0, m, MLP_PLAIN_ROWS):
                plain(r, r + MLP_PLAIN_ROWS)

        out["plain_ms"] = once_ms(whole, lambda: plain(0, MLP_PLAIN_ROWS))[0]
    torch.cuda.empty_cache()
    log("mlp_fused_timing", dp=pa.shape[1], **out)
    return out


def packed_target_values(plan, packed, target_idx):
    """Each row's target block [B, S, max_dim] gathered from a packed [B,
    S, total]: the per-node dynamic sweep's read before its node-major
    store (two uploads of the plan's offsets and dims, then a gather whose
    rows lie ``total`` floats apart)."""
    import torch

    dev = packed.device
    offs = torch.tensor(plan.node_offsets, dtype=torch.int64, device=dev)
    dims = torch.tensor(plan.node_dims, dtype=torch.int64, device=dev)
    ti = target_idx.long()
    max_d = int(max(plan.node_dims))
    cols = offs[ti][:, None] + torch.arange(max_d, device=dev)[None]
    keep = torch.arange(max_d, device=dev)[None] < dims[ti][:, None]
    cols = torch.clamp(cols, max=plan.total_dim - 1)
    b, s = packed.shape[:2]
    got = packed.gather(2, cols[:, None, :].expand(b, s, max_d))
    return torch.where(keep[:, None, :], got, 0.0)


def node_planes_timing(b=N_DYN, s=S_MAIN, n=8, rounds=5):
    """Phase node_planes (see the module note)."""
    import torch

    from vectorizedbayesiannetwork_torch.inference._dynamic_sweep import (
        dynamic_target_values,
    )

    plan = types.SimpleNamespace(node_offsets=tuple(range(n)),
                                 node_dims=(1,) * n, total_dim=n)
    gen = torch.Generator(device="cuda").manual_seed(26)
    planes = torch.randn((n, b, s), device="cuda", generator=gen)
    vals = [planes[i][:, :, None].clone() for i in range(n)]
    ti = torch.randint(0, n, (b,), device="cuda", generator=gen,
                       dtype=torch.int32)
    routes = {
        "packed": lambda: packed_target_values(plan, torch.cat(vals, dim=-1),
                                               ti),
        "planes": lambda: dynamic_target_values(plan, planes, ti),
    }
    equal = torch.equal(routes["planes"](), routes["packed"]())
    ms = {k: [] for k in routes}
    for _ in range(rounds):
        for k in ("packed", "planes", "planes", "packed"):
            ms[k].append(cuda_ms(routes[k], 1))
    # the gnn network's parent concatenations: x3, x5 (3), x7 (2), x6 (1)
    views = [planes[i][:, :, None] for i in range(n)]
    extra = {
        "cat_ms": lambda: torch.cat(vals, dim=-1),
        "parent_cats_ms": lambda: [torch.cat(views[:k], dim=-1)
                                   for k in (3, 3, 2, 1)],
    }
    rec = {"rows": b, "particles": s, "planes": n, "equal": equal,
           **{f"{k}_ms": float(np.median(v)) for k, v in ms.items()},
           **{f"{k}_all": v for k, v in ms.items()},
           **{k: cuda_ms(fn, 3) for k, fn in extra.items()},
           "planes_bound_ms": 1e3 * 2 * 4 * b * s / PEAK_BYTES}
    del planes, vals, views
    torch.cuda.empty_cache()
    log("node_planes", **rec)
    if not equal:
        raise AssertionError("the planes' target blocks differ from the "
                             "packed route's")
    return rec


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="also time the redesigned kernels of the checkout at "
                         "DIR beside this one's (compare_builds)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from vectorizedbayesiannetwork_torch import VBN, defaults
    from vectorizedbayesiannetwork_torch.ops import _build

    t_start = time.perf_counter()
    secs = _build.build_all()
    log("build", seconds=secs)
    regs = [r for name in _build.SOURCES
            for r in ptxas_report(_build.build_log(name))]
    log("kernel_registers", kernels=regs)
    spilled = [r["kernel"] for r in regs if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")
    for name, kernels in SASS_KERNELS.items():
        log("kernel_sass", source=f"csrc/{name}.cu", kernels=[
            r for r in sass_report(_build.library_path(name))
            if r["kernel"].split("<")[0] in kernels])

    t0 = time.perf_counter()
    bn, asia_vbn = fit_asia(VBN, defaults)
    lg_vbn = fit_flagship(VBN, defaults)
    asia_vbn.set_inference_method("likelihood_weighting", n_samples=S_MAIN)
    lg_vbn.set_inference_method("monte_carlo_marginalization", n_samples=S_MAIN)
    torch.cuda.synchronize()
    log("fit", seconds=time.perf_counter() - t0)

    errs = check_kernels(asia_vbn, lg_vbn)
    log("kernel_check_done", max_abs_err=errs)
    check_lg_sweep_matches_scan(lg_vbn)

    torch.cuda.reset_peak_memory_stats()
    launches, phase4 = serve_main_path(bn, asia_vbn, lg_vbn)
    log("main_path_memory",
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())

    kernels = time_kernels(asia_vbn, lg_vbn, launches, errs)
    qa, ql = asia_query(B_MAIN), flagship_query(B_MAIN)
    torch.cuda.reset_peak_memory_stats()
    asia_qps, asia_w = end_to_end_qps(
        lambda: asia_vbn.infer_posterior_pmf([qa] * REPS, n_classes=2), B_MAIN)
    lg_qps, lg_w = end_to_end_qps(
        lambda: lg_vbn.infer_posterior_moments([ql] * REPS), B_MAIN)
    log("end_to_end", asia_lw_pmf_qps=asia_qps, asia_window_qps=asia_w,
        flagship_mcm_moments_qps=lg_qps, flagship_window_qps=lg_w,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    # where a served batch's time goes: the kernel's share of it (the rest
    # is host work, the partials' combine and the fetch of the rows)
    for tag, qps, row in (("asia", asia_qps, kernels[0]),
                          ("flagship", lg_qps, kernels[1])):
        batch_ms = 1e3 * B_MAIN / qps
        log("serve_breakdown", workload=tag, batch_ms=batch_ms,
            kernel_ms=row["ms"], kernel_share=row["ms"] / batch_ms)

    scan_rows, link, gauss = serve_large_networks(VBN, defaults, asia_vbn)
    kernels += scan_rows
    kernels += serve_resampling(bn, asia_vbn, lg_vbn, link)
    kernels += serve_kde(VBN, defaults)
    serve_exact(VBN, defaults, bn, asia_vbn, lg_vbn)
    neural, sm = serve_neural(VBN, defaults, bn, asia_vbn)
    mlp_row = check_mlp_fused(KEPT["b_gauss_mlp_launches"])
    node_planes_timing()
    level = serve_level_group(VBN, defaults)
    sampling = serve_sampling(VBN, defaults, sm)
    serve_updates(VBN, defaults)
    slice13 = serve_slice13(VBN, defaults, bn, asia_vbn, lg_vbn)
    from vectorizedbayesiannetwork_torch.inference import _sweep

    # the torch-op sweeps of phases 1-24 by route: a stacked form here
    # would be a phase that the 64-node routing moved
    log("sweep_routes_phases_1_24", routes=dict(_sweep.ROUTES))
    slice14 = serve_slice14(VBN, defaults, bn, lg_vbn)
    uniforms = check_uniforms(torch.device("cuda"))
    row0 = row0_invariance(lg_vbn)
    for case, got in level.items():
        uniforms[f"launches_level_group_{case}"] = got
    serve_torch_routes(asia_vbn, lg_vbn)
    mesh = serve_mesh(bn, asia_vbn, lg_vbn, phase4, link, gauss)
    # (m3), t3's stacked form on the one-rank mesh, is this row's main
    # path; the chain samplers' draws (s2-s4, phase 27) have their own keys
    uniforms["launches"] = mesh["m3"]["uniforms"]
    uniforms["launches_row0_chains"] = {
        k: v["uniforms"] for k, v in row0.items() if "uniforms" in v}
    uniforms["launches_m2"] = mesh["m2"].get("uniforms", 0)
    kernels.append(uniforms)
    kernels.append(mlp_row)
    for row in kernels:
        key = {"vbn_cumsum": "cumsum", "vbn_srg": "srg"}.get(row["name"])
        if key:
            row["launches_neural_main_path"] = neural.get(key, 0)
        key = {"vbn_kde_root": "kde_root", "vbn_kde_cond": "kde_cond",
               "vbn_kde_pick": "kde_pick",
               "vbn_uniforms": "uniforms"}.get(row["name"])
        if key:
            row["launches_sampling_main_path"] = sampling.get(key, 0)
            for phase, got in slice13.items():
                row[f"launches_{phase}"] = got.get(key, 0)
        key = {"vbn_cat_sweep": "categorical", "vbn_lg_sweep": "lg",
               "vbn_uniforms": "uniforms"}.get(row["name"])
        if key:
            for phase, got in slice14.items():
                row[f"launches_{phase}"] = got.get(key, 0)
        key = {"vbn_cat_sweep": "categorical", "vbn_lg_sweep": "lg",
               "vbn_cat_scan": "categorical_scan", "vbn_lg_scan": "lg_scan",
               "vbn_cumsum": "cumsum", "vbn_spg": "spg"}.get(row["name"])
        if key:
            for phase, got in mesh.items():
                row[f"launches_{phase}"] = got.get(key, 0)
    if args.parent:
        compare_builds(args.parent)
        compare_samplers({"parent": args.parent})
    log("chip_smoke_done", seconds=time.perf_counter() - t_start)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
