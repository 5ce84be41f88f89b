#!/usr/bin/env python
"""Smoke test of dgnn's main path on NVIDIA GPUs.

    python chip_smoke.py           # one card: phases (a)-(c)
    python chip_smoke.py --four    # four cards: phase (d) only

(a) the fused ops (gat_aggregate, gmm_aggregate_node, edge_conv_max) against
    the plain references (ops/naive.py, ops/reference.py) at real widths on
    the pubmed-shaped graph and a 0.1-scale Reddit R-MAT, forward and
    gradients, with attention dropout;
(b) GAT at the reference config on the Reddit-scale graph: Adam training
    steps and one inference pass, set-up time apart from step time;
(c) MoNet on pubmed and DGCNN on ModelNet40-shaped clouds, a few training
    steps each;
(d) ShardedGAT training over four cards (halo all_to_all) against a
    single-card run of the same graph: loss and gradients.

Everything runs in this one process.  The script exits non-zero, and prints
no result line, when JAX finds no GPU or the repository is not beside it;
any failed check fails the run.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()


def log(msg):
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


class Check:
    """Collects named comparisons; any failure fails the run at the end."""

    def __init__(self):
        self.failed = []

    def close(self, name, got, ref, tol, why):
        import numpy as np

        got = np.asarray(got, np.float64)
        ref = np.asarray(ref, np.float64)
        if got.shape != ref.shape:
            self.failed.append(f"{name}: shape {got.shape} vs {ref.shape}")
            log(f"FAIL {name}: shape {got.shape} vs {ref.shape}")
            return
        err = float(np.max(np.abs(got - ref))) if got.size else 0.0
        scale = float(np.max(np.abs(ref))) if ref.size else 0.0
        rel = err / max(scale, 1e-30)
        ok = bool(np.all(np.isfinite(got))) and rel <= tol
        log(f"{'ok  ' if ok else 'FAIL'} {name}: max abs err {err:.3e}, "
            f"rel to max|ref| {rel:.3e} (tol {tol:g}: {why})")
        if not ok:
            self.failed.append(name)

    def true(self, name, cond, detail=""):
        log(f"{'ok  ' if cond else 'FAIL'} {name} {detail}")
        if not cond:
            self.failed.append(name)


# Tolerances, relative to the reference's largest magnitude.  The
# references run at matmul precision "highest"; the fused ops at the
# default precision, where float32 products may use TF32 (~1e-3 relative),
# and sum in another order (bins, segments, chunks).  bf16 gathered rows
# keep 8 bits of mantissa (~4e-3 relative per element).
TOL_F32 = (2e-3, "TF32 products and order of summation")
TOL_BF16 = (2e-2, "bf16 gathered rows, TF32 products, order of summation")


def _edge_rows(row_ptr):
    import numpy as np

    return np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))


def _reddit_raw(scale):
    """COO (src, dst) and node/edge counts of the Reddit R-MAT at scale."""
    from dgnn.data.synthetic import CITATION_SHAPES, rmat_edges

    n_full, e_full, din, ncls = CITATION_SHAPES["reddit"]
    n, e = int(n_full * scale), int(e_full * scale)
    src, dst = rmat_edges(n, e, seed=0)
    return src, dst, n, din, ncls


def phase_ops(chk, reddit_scale=0.1):
    """(a) fused ops vs the plain references at real widths."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dgnn.data import load_citation_dataset
    from dgnn.graph.knn import knn_graph
    from dgnn.graph.structure import build_graph
    from dgnn.ops import reference
    from dgnn.ops.edgeconv import edge_conv_max
    from dgnn.ops.gat import gat_aggregate
    from dgnn.ops.gmm import gmm_aggregate_node
    from dgnn.ops.naive import gat_naive, gmm_naive

    hi = jax.default_matmul_precision("highest")
    d = load_citation_dataset("pubmed", seed=0)
    graphs = [("pubmed", d.src, d.dst, d.num_nodes, 500)]
    src, dst, n, din, _ = _reddit_raw(reddit_scale)
    graphs.append((f"reddit x{reddit_scale}", src, dst, n, din))
    # (gather dtype, attention dropout, tolerance): f32 gathers check the
    # algorithm; bf16 gathers (the Reddit benchmark cells) are compared with
    # the reference on the same bf16-rounded features
    cases = [(None, 0.5, TOL_F32), (jnp.bfloat16, 0.5, TOL_BF16)]
    for name, src, dst, n, din in graphs:
        t = time.time()
        g = build_graph(src, dst, n, edge_tables=False)
        log(f"{name}: {n} nodes, {g.num_edges} edges, built in "
            f"{time.time() - t:.1f}s; bins fwd {g.fwd.widths} "
            f"bwd {g.bwd.widths}")
        rng = np.random.default_rng(1)
        H, F = 4, 64
        feat = jnp.asarray(rng.normal(size=(n, din)), jnp.float32)
        W = jnp.asarray(rng.normal(size=(din, H * F)) / np.sqrt(din),
                        jnp.float32)
        with hi:
            x = (feat @ W).reshape(n, H, F)
        ar = jnp.asarray(rng.normal(size=(n, H)), jnp.float32)
        ac = jnp.asarray(rng.normal(size=(n, H)), jnp.float32)
        ct = jnp.asarray(rng.normal(size=(n, H, F)), jnp.float32)
        key = jax.random.PRNGKey(3)
        for gd, p, (tol, why) in cases:
            # the graph is a jit argument: closed over, its arrays would
            # become constants that XLA folds for minutes
            @jax.jit
            def fused(g, ar, ac, x, p=p, gd=gd):
                return gat_aggregate(g, ar, ac, x, attn_drop=p, key=key,
                                     training=p > 0, gather_dtype=gd)

            @jax.jit
            def naive(g, ar, ac, x, p=p, gd=gd):
                if gd is not None:
                    x = x.astype(gd).astype(jnp.float32)
                with hi:
                    return gat_naive(g, ar, ac, x, attn_drop=p, key=key,
                                     training=p > 0)

            out, vjp = jax.vjp(functools.partial(fused, g), ar, ac, x)
            grads = vjp(ct)
            ref, vjp_r = jax.vjp(functools.partial(naive, g), ar, ac, x)
            grads_r = vjp_r(ct)
            tag = (f"{name} gat H={H} F={F} din={din} attn_drop={p} "
                   f"gather {jnp.dtype(gd or jnp.float32).name}")
            chk.close(f"{tag} forward", out, ref, tol, why)
            for gn, a, b in zip(("d_attn_row", "d_attn_col", "d_feat"),
                                grads, grads_r):
                chk.close(f"{tag} {gn}", a, b, tol, why)
            del out, vjp, grads, ref, vjp_r, grads_r

        # MoNet aggregation, node-derived pseudo (citation protocol)
        K, D = 3, 2
        deg = np.maximum(np.diff(np.asarray(g.row_ptr)), 1).astype(np.float32)
        rsq = jnp.asarray(1.0 / np.sqrt(deg))[:, None]
        xk = jnp.asarray(rng.normal(size=(n, K, F)), jnp.float32)
        mu = jnp.asarray(rng.normal(scale=0.1, size=(K, D)), jnp.float32)
        isig = jnp.asarray(rng.random((K, D)) + 0.5, jnp.float32)
        pw = jnp.asarray(rng.normal(size=(2, D)), jnp.float32)
        pb = jnp.asarray(rng.normal(size=(D,)), jnp.float32)
        rows = jnp.asarray(_edge_rows(np.asarray(g.row_ptr)), jnp.int32)

        ctk = jnp.asarray(rng.normal(size=(n, K, F)), jnp.float32)
        for gd, (tol, why) in ((None, TOL_F32), (jnp.bfloat16, TOL_BF16)):
            @jax.jit
            def gmm_fused(g, rsq, xk, pw, pb, mu, isig, gd=gd):
                return gmm_aggregate_node(g, xk, rsq, rsq, mu, isig,
                                          proj_weight=pw, proj_bias=pb,
                                          gather_dtype=gd)

            @jax.jit
            def gmm_ref(g, rsq, rows, xk, pw, pb, mu, isig, gd=gd):
                if gd is not None:
                    xk = xk.astype(gd).astype(jnp.float32)
                with hi:
                    praw = jnp.concatenate([rsq[g.col_ind], rsq[rows]],
                                           axis=1)
                    pseudo = jnp.tanh(praw @ pw + pb)
                    return gmm_naive(g, xk, pseudo, mu, isig)

            args = (xk, pw, pb, mu, isig)
            out, vjp = jax.vjp(functools.partial(gmm_fused, g, rsq), *args)
            ref, vjp_r = jax.vjp(functools.partial(gmm_ref, g, rsq, rows),
                                 *args)
            tag = (f"{name} monet K={K} dim={D} F={F} gather "
                   f"{jnp.dtype(gd or jnp.float32).name}")
            chk.close(f"{tag} forward", out, ref, tol, why)
            for gn, a, b in zip(("d_feat", "d_proj_w", "d_proj_b", "d_mu",
                                 "d_inv_sigma"), vjp(ctk), vjp_r(ctk)):
                chk.close(f"{tag} {gn}", a, b, tol, why)
            del out, vjp, ref, vjp_r
        del g

    # EdgeConv neighbour max on ModelNet-shaped clouds (B=64, 1024, k=40)
    rng = np.random.default_rng(2)
    B, P, k, C = 64, 1024, 40, 64
    pts = jnp.asarray(rng.normal(size=(B, P, 3)), jnp.float32)
    nbr = knn_graph(pts, k)  # [B*P, k] flat ids, exact
    hs = jnp.asarray(rng.normal(size=(B * P, C)), jnp.float32)
    hd = jnp.asarray(rng.normal(size=(B * P, C)), jnp.float32)
    out, vjp = jax.vjp(functools.partial(jax.jit(edge_conv_max), nbr), hs,
                       hd)
    ref, vjp_r = jax.vjp(functools.partial(
        jax.jit(reference.edgeconv_dense), nbr), hs, hd)
    cte = jnp.asarray(rng.normal(size=(B * P, C)), jnp.float32)
    tag = f"edgeconv B={B} points={P} k={k} C={C}"
    chk.close(f"{tag} forward", out, ref, 0.0, "max is exact")
    for gn, a, b in zip(("d_h_src", "d_h_dst"), vjp(cte), vjp_r(cte)):
        chk.close(f"{tag} {gn}", a, b, 1e-6, "argmax routing is exact")


def phase_gat_reddit(chk, scale=1.0):
    """(b) GAT at the reference config on the Reddit-scale graph."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from dgnn.graph.structure import build_graph
    from dgnn.models import GAT

    t = time.time()
    src, dst, n, din, ncls = _reddit_raw(scale)
    t_rmat = time.time() - t
    t = time.time()
    g = build_graph(src, dst, n, edge_tables=False).slim()
    del src, dst
    t_bins = time.time() - t
    log(f"reddit x{scale}: {n} nodes, {g.num_edges} edges; R-MAT "
        f"{t_rmat:.1f}s, CSR/CSC + binning {t_bins:.1f}s; bins fwd "
        f"{g.fwd.widths} bwd {g.bwd.widths}")
    rng = np.random.default_rng(0)
    feat = jnp.asarray(rng.normal(size=(n, din)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, ncls, n).astype(np.int32))
    model = GAT(num_layers=1, n_hidden=64, n_classes=ncls, heads=(4, 1),
                feat_drop=0.5, gather_dtype="bfloat16")
    params = model.init(jax.random.PRNGKey(0), din)
    tx = optax.adam(1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, graph, feat, labels, key):
        def loss_fn(p):
            logits = model.apply(p, graph, feat, training=True, key=key)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), opt, loss

    infer = jax.jit(lambda p, graph, feat: model.apply(p, graph, feat))
    t = time.time()
    step_c = step.lower(params, opt, g, feat, labels,
                        jax.random.PRNGKey(1)).compile()
    infer_c = infer.lower(params, g, feat).compile()
    log(f"reddit GAT compile {time.time() - t:.1f}s")
    losses, times = [], []
    for i in range(3):
        t = time.time()
        params, opt, loss = step_c(params, opt, g, feat, labels,
                                   jax.random.PRNGKey(10 + i))
        losses.append(float(loss))
        times.append(time.time() - t)
    t = time.time()
    logits = jax.block_until_ready(infer_c(params, g, feat))
    t_inf = time.time() - t
    log(f"reddit GAT train step times {['%.4f' % x for x in times]} s, "
        f"losses {losses}; inference {t_inf:.4f} s")
    chk.true("reddit GAT losses finite", bool(np.all(np.isfinite(losses))),
             str(losses))
    chk.true("reddit GAT logits finite, shape", logits.shape == (n, ncls)
             and bool(jnp.all(jnp.isfinite(logits))), str(logits.shape))


def phase_monet_dgcnn(chk, bs=64, pts=1024):
    """(c) MoNet on pubmed and DGCNN on ModelNet40-shaped clouds."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from dgnn.data import load_citation_dataset, load_modelnet
    from dgnn.graph.structure import build_graph
    from dgnn.models import DGCNN, MoNet
    from dgnn.ops.gmm import NodePseudo

    d = load_citation_dataset("pubmed", seed=0)
    g = build_graph(d.src, d.dst, d.num_nodes, edge_tables=False)
    deg = jnp.maximum(g.in_degrees().astype(jnp.float32), 1.0)
    rsq = jax.lax.rsqrt(deg)[:, None]
    pseudo = NodePseudo(src=rsq, dst=rsq)
    g = g.slim()
    feat, labels = jnp.asarray(d.features), jnp.asarray(d.labels)
    model = MoNet(n_hidden=64, out_feats=d.n_classes, n_layers=1, dim=2,
                  n_kernels=3, dropout=0.5)
    params = model.init(jax.random.PRNGKey(0), feat.shape[1], pseudo)
    tx = optax.adam(1e-2)
    opt = tx.init(params)

    @jax.jit
    def mstep(params, opt, key):
        def loss_fn(p):
            lg = model.apply(p, g, feat, pseudo, training=True, key=key)
            return optax.softmax_cross_entropy_with_integer_labels(
                lg, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), opt, loss

    losses = []
    for i in range(5):
        params, opt, loss = mstep(params, opt, jax.random.PRNGKey(i))
        losses.append(float(loss))
    log(f"monet pubmed K=3 losses {losses}")
    chk.true("monet pubmed losses finite", bool(np.all(np.isfinite(losses))))

    k = 40
    xtr, ytr, _, _ = load_modelnet(num_points=pts, train_samples=2 * bs,
                                   test_samples=bs)
    ncls = 40
    dg = DGCNN(k=k, output_classes=ncls, dropout=0.5)
    params, state = dg.init(jax.random.PRNGKey(0))
    dtx = optax.sgd(0.1, momentum=0.9)
    dopt = dtx.init(params)

    @jax.jit
    def dstep(params, state, opt, x, y, key):
        def loss_fn(p):
            lg, st = dg.apply(p, state, x, training=True, key=key)
            oh = jax.nn.one_hot(y, ncls)
            sm = oh * 0.8 + (1 - oh) * 0.2 / (ncls - 1)
            return -(sm * jax.nn.log_softmax(lg, 1)).sum(1).mean(), st

        (loss, state), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        upd, opt = dtx.update(grads, opt, params)
        return optax.apply_updates(params, upd), state, opt, loss

    losses = []
    for i in range(3):
        x = jnp.asarray(xtr[(i % 2) * bs:(i % 2 + 1) * bs])
        y = jnp.asarray(ytr[(i % 2) * bs:(i % 2 + 1) * bs])
        params, state, dopt, loss = dstep(params, state, dopt, x, y,
                                          jax.random.PRNGKey(i))
        losses.append(float(loss))
    log(f"dgcnn B={bs} points={pts} k={k} losses {losses}")
    chk.true("dgcnn losses finite", bool(np.all(np.isfinite(losses))))


def phase_four(chk, scale=1.0):
    """(d) ShardedGAT over four cards vs one card: loss and gradients."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from dgnn.graph.structure import build_graph
    from dgnn.models import GAT
    from dgnn.parallel import ShardedGAT, local_view, partition_graph

    devs = jax.devices()
    chk.true("four GPUs", len(devs) >= 4, f"have {len(devs)}")
    if len(devs) < 4:
        return
    t = time.time()
    src, dst, n, din, ncls = _reddit_raw(scale)
    shards = partition_graph(src, dst, n, 4)
    t_part = time.time() - t
    t = time.time()
    g = build_graph(src, dst, n, edge_tables=False).slim()
    del src, dst
    log(f"reddit x{scale}: partition over 4 {t_part:.1f}s (halo max "
        f"{shards.halo_max}), single-card build {time.time() - t:.1f}s")
    n_pad = shards.padded_nodes
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(n, din)).astype(np.float32)
    labels = rng.integers(0, ncls, n).astype(np.int32)
    feat_pad = np.zeros((n_pad, din), np.float32)
    feat_pad[:n] = feat
    lab_pad = np.zeros(n_pad, np.int32)
    lab_pad[:n] = labels
    mask_pad = np.zeros(n_pad, np.float32)
    mask_pad[:n] = 1.0

    kw = dict(num_layers=1, n_hidden=64, n_classes=ncls, heads=(4, 1),
              attn_drop=0.5)
    single, sharded = GAT(**kw), ShardedGAT(**kw)
    params = single.init(jax.random.PRNGKey(0), din)
    key = jax.random.PRNGKey(5)

    def xent(logits, y):
        return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                    y[:, None], axis=1)[:, 0]

    @jax.jit
    def loss_single(p, graph, x, y):
        return jnp.mean(xent(single.apply(p, graph, x, training=True,
                                          key=key), y))

    mesh = Mesh(np.array(devs[:4]), ("graph",))
    fwd = shard_map(lambda p, s, x: sharded.apply(p, local_view(s), x,
                                                   training=True, key=key),
                    mesh=mesh, in_specs=(P(), P("graph"), P("graph")),
                    out_specs=P("graph"))

    @jax.jit
    def loss_sharded(p, s, x, y, m):
        return jnp.sum(xent(fwd(p, s, x), y) * m) / n

    t = time.time()
    l1, g1 = jax.value_and_grad(loss_single)(
        params, g, jnp.asarray(feat), jnp.asarray(labels))
    l1 = float(l1)
    log(f"single card: loss {l1:.6f} ({time.time() - t:.1f}s incl. "
        f"compile)")
    del g
    t = time.time()
    l4, g4 = jax.value_and_grad(loss_sharded)(
        params, shards, jnp.asarray(feat_pad), jnp.asarray(lab_pad),
        jnp.asarray(mask_pad))
    l4 = float(l4)
    log(f"four cards: loss {l4:.6f} ({time.time() - t:.1f}s incl. compile)")
    tol, why = TOL_F32
    chk.close("sharded vs single loss", l4, l1, tol, why)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g4),
                            jax.tree.leaves(g1)):
        chk.close(f"sharded vs single grad {jax.tree_util.keystr(path)}",
                  a, b, tol, why)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "dgnn")):
        sys.exit("chip_smoke.py: the dgnn package is not beside this script")
    sys.path.insert(0, HERE)
    # one process owns the card(s); give it most of the memory for the
    # edge-materializing references of phase (a)
    os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.92")
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py: JAX found no GPU (platform "
                 f"{devs[0].platform!r})")
    from dgnn.utils import enable_compile_cache

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}"
          f"; compile cache {enable_compile_cache()}", flush=True)
    chk = Check()
    if args.four:
        phase_four(chk)
    else:
        phase_ops(chk)
        phase_gat_reddit(chk)
        phase_monet_dgcnn(chk)
    peak = devs[0].memory_stats()["peak_bytes_in_use"] / 2 ** 30
    log(f"peak device memory {peak:.2f} GiB (card 0)")
    if chk.failed:
        sys.exit(f"chip_smoke.py: {len(chk.failed)} check(s) failed: "
                 f"{chk.failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
