"""The port's meshed sweeps against the JAX package's, on a 2x2 mesh.

The JAX side runs its four shard forms (``sweep_pallas._shard_sweep`` for
the categorical and the LG kernel, ``sweep_scan_pallas._shard_scan_sweep``
and ``_shard_lg_scan``) under ``shard_map`` on four of its virtual CPU
devices, its Pallas kernels in interpret mode, where each shard draws its
uniforms from ``fold_in(fold_in(key, di * npart + pi), 1)``. The port runs
``make_fused_sweep_fn`` / ``make_scan_sweep_fn`` with ``mesh=`` on a
four-rank gloo group (``tests/torch_mesh_ranks.py``); each rank is handed
the JAX shard's uniform block. Every rank must return the whole result,
and it must match JAX's within ``tests/test_torch_sweep.py``'s tolerances:
classes exact, log-weights and log-densities atol 1e-4 (LG: targets 2e-4,
log-densities 2e-3), pmf rtol 2e-4, moments rtol 2e-3.
"""

import numpy as np
import pytest

from torch_mesh_ranks import N_DATA, WORLD, load, spawn_ranks

B, S = 4, 1 << 14
NPART = WORLD // N_DATA
CAT_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("pmf_logw",),
             ("pmf_lpt",), ("mom_logw",), ("mom_lpt",)]
LG_WANTS = [("logw", "lpt"), ("logw", "tgt"), ("lpt",), ("mom_logw",),
            ("mom_lpt",)]
CASES = ([("cat", "unrolled", w) for w in CAT_WANTS]
         + [("lg", "unrolled", w) for w in LG_WANTS]
         + [("cat", "scan", w) for w in CAT_WANTS]
         + [("lg", "scan", w) for w in LG_WANTS])


def _name(case):
    tag, form, want = case
    return f"{tag}|{form}|{','.join(want)}"


def _jax_models(d):
    """The asia and chain models fitted by the JAX package, saved for the
    ranks; returns {tag: (vbn, query)}."""
    import networkx as nx

    from benchmarking.data_gen import generate_dataset
    from benchmarking.networks import asia
    from conftest import make_chain_df, make_chain_graph
    from vectorizedbayesiannetwork_tpu import VBN, defaults
    from vectorizedbayesiannetwork_tpu.core.base import Query

    bn = asia()
    g = nx.DiGraph()
    g.add_nodes_from(bn.nodes)
    g.add_edges_from(bn.edges())
    cat = VBN(g, seed=0)
    conf = {}
    for node in bn.nodes:
        c = dict(defaults.cpd("categorical_table"), n_classes=bn.card(node))
        if bn.parents[node]:
            c["parent_n_classes"] = [bn.card(p) for p in bn.parents[node]]
        conf[node] = c
    cat.set_learning_method("node_wise", nodes_cpds=conf)
    data = generate_dataset(bn, 4096, seed=0)
    cat.fit({k: np.asarray(v, np.float32).reshape(-1, 1)
             for k, v in data.items()})
    lg = VBN(make_chain_graph(), seed=0)
    lg.set_learning_method("node_wise", nodes_cpds={
        k: defaults.cpd("linear_gaussian") for k in ("x0", "x1", "x2")})
    lg.fit(make_chain_df())
    col = lambda *v: np.asarray(v, np.float32).reshape(-1, 1)  # noqa: E731
    queries = {
        "cat": Query(target="dysp",
                     evidence={"smoke": col(1, 0, 1, 0), "asia": col(0, 0, 1, 1)},
                     do={"xray": col(1, 1, 0, 1)}),
        "lg": Query(target="x2", evidence={"x0": col(0.5, -0.3, 1.0, 0.0)},
                    do={}),
    }
    dyn = {
        "cat": [Query("dysp", {"smoke": col(1)}, {}),
                Query("lung", {"dysp": col(1), "xray": col(0)}, {}),
                Query("either", {}, {"smoke": col(0)}),
                Query("bronc", {"asia": col(1)}, {})],
        "lg": [Query("x2", {"x0": col(0.4)}, {}),
               Query("x0", {"x2": col(0.7)}, {}),
               Query("x1", {"x2": col(-0.2)}, {"x0": col(1.0)}),
               Query("x2", {}, {})],
    }
    models = {"cat": cat, "lg": lg}
    for tag, v in models.items():
        v.save(str(d / tag))
    return models, queries, dyn


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """(JAX outputs by case, every rank's outputs)."""
    import jax
    import jax.numpy as jnp

    from vectorizedbayesiannetwork_tpu.core.plan import (
        get_plan,
        pack_fixed_values,
    )
    from vectorizedbayesiannetwork_tpu.inference._dynamic_base import (
        pack_dynamic_inputs,
    )
    from vectorizedbayesiannetwork_tpu.ops.sweep_pallas import (
        make_fused_sweep_fn,
    )
    from vectorizedbayesiannetwork_tpu.ops.sweep_scan_pallas import (
        make_scan_sweep_fn,
    )
    from vectorizedbayesiannetwork_tpu.parallel.mesh import make_mesh

    d = tmp_path_factory.mktemp("mesh_sweep")
    models, queries, dyn = _jax_models(d)
    mesh = make_mesh(n_data=N_DATA, devices=jax.devices()[:WORLD])
    inputs, expect = {}, {}
    for tag, q in queries.items():
        inputs[f"{tag}:target"] = np.asarray(q.target)
        inputs[f"{tag}:evidence"] = np.asarray(sorted(q.evidence), dtype=str)
        inputs[f"{tag}:do"] = np.asarray(sorted(q.do), dtype=str)
    for i, case in enumerate(CASES):
        tag, form, want = case
        vbn, name = models[tag], _name(case)
        key = jax.random.PRNGKey(100 + i)
        if form == "unrolled":
            plan = get_plan(vbn, queries[tag])
            fixed = pack_fixed_values(queries[tag], plan, B,
                                      clamp_obs=tag == "cat")
            args = (fixed,)
            raw = make_fused_sweep_fn(
                plan, tuple(vbn.cpd_spec(n) for n in plan.topo_order), S,
                want=want, mesh=mesh, batch=B)
        else:
            topo = tuple(vbn.dag.topological_order())
            from vectorizedbayesiannetwork_tpu.core.base import Query

            plan = get_plan(vbn, Query(target=topo[0], evidence={}, do={}))
            args, _, _, _ = pack_dynamic_inputs(plan, dyn[tag], clamp_obs=True)
            inputs[f"{name}:ev"], inputs[f"{name}:do"] = args[1], args[2]
            inputs[f"{name}:tgt"] = args[3]
            raw = make_scan_sweep_fn(
                plan, tuple(vbn.cpd_spec(n) for n in plan.topo_order), S,
                want=want, mesh=mesh)
            assert raw.fits(B)
        assert raw is not None, name
        params = tuple(vbn.params[n] for n in plan.topo_order)
        out = raw(params, key, *(jnp.asarray(a) for a in args))
        expect[name] = jax.tree_util.tree_map(np.asarray, out)
        inputs[f"{name}:fixed"] = np.asarray(args[0], np.float32)
        inputs[f"{name}:s"] = np.asarray(S)
        rows = plan.n_nodes * (2 if tag == "lg" else 1)
        for di in range(N_DATA):
            for pi in range(NPART):
                k = jax.random.fold_in(key, di * NPART + pi)
                inputs[f"{name}:u{di}{pi}"] = np.asarray(jax.random.uniform(
                    jax.random.fold_in(k, 1), (B // N_DATA, rows, S // NPART),
                    minval=1e-6, maxval=1.0 - 1e-6))
    np.savez(d / "inputs.npz", **inputs)
    spawn_ranks(d, ["sweep"])
    return expect, [load(d, "sweep", r) for r in range(WORLD)]


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_shard_form_matches_jax_mesh(mesh_run, case):
    expect, ranks = mesh_run
    name = _name(case)
    tag, form, want = case
    j_logw, j_tgt, j_lpt, j_red = expect[name]
    got = ranks[0]
    lp_atol = 1e-4 if tag == "cat" else 2e-3
    for label, jo in (("logw", j_logw), ("tgt", j_tgt), ("lpt", j_lpt)):
        assert (jo is None) == (f"{name}:{label}" not in got), label
        if jo is None:
            continue
        to = got[f"{name}:{label}"]
        assert to.shape == (B, S)
        if label == "tgt" and tag == "cat":
            np.testing.assert_array_equal(to, jo)
        else:
            atol = 2e-4 if label == "tgt" else lp_atol
            np.testing.assert_allclose(to, jo, atol=atol)
    assert (j_red is None) == (f"{name}:sums" not in got)
    if j_red is not None:
        j_sums, j_m = j_red
        t_sums, t_m = got[f"{name}:sums"], got[f"{name}:m"]
        np.testing.assert_allclose(t_m, j_m, atol=lp_atol)
        k = t_sums.shape[1]
        rtol = 2e-4 if want[0].startswith("pmf") else 2e-3
        np.testing.assert_allclose(t_sums, j_sums[:, :k], rtol=rtol, atol=1e-6)
        assert np.allclose(j_sums[:, k:], 0.0)  # JAX pads to 128 lanes
    # every rank holds the whole result
    for other in ranks[1:]:
        for k in got:
            if k.startswith(name + ":"):
                np.testing.assert_array_equal(other[k], got[k])
