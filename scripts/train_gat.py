#!/usr/bin/env python
"""GAT training CLI (reference analogue: dgNN/script/train/train_gatconv.py).

Same flags, measurement protocol (warmup + synchronized per-epoch wall clock
for train and inference) and CSV schema as the reference, on JAX.
Datasets load from disk when present, else deterministic synthetic graphs at
the same scale.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax
import jax.numpy as jnp
import optax

from dgnn.data import load_node_task
from dgnn.models import GAT
from dgnn.utils import (append_csv_row, enable_compile_cache,
                        peak_memory_mb, run_epochs, time_epoch_loop)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(args):
    enable_compile_cache()
    (graph, features, labels, train_mask, test_mask,
     n_classes) = load_node_task(args.dataset, args.seed,
                                 os.path.join(REPO, ".bench_cache"))

    heads = [args.n_heads] * args.n_layers + [1]
    model = GAT(num_layers=args.n_layers, n_hidden=args.n_hidden,
                n_classes=n_classes, heads=heads,
                feat_drop=args.dropout, attn_drop=args.attn_drop,
                negative_slope=args.negative_slope, impl=args.impl)

    key = jax.random.PRNGKey(args.seed)
    params = model.init(key, features.shape[1])
    # torch.optim.Adam(weight_decay=...) couples L2 into the gradient
    tx = optax.chain(optax.add_decayed_weights(args.weight_decay),
                     optax.adam(args.lr))
    opt_state = tx.init(params)

    def train_step(carry, dropout_key, cs):
        graph, features, labels, train_mask = cs
        params, opt_state, _ = carry

        def loss_fn(p):
            logits = model.apply(p, graph, features, training=True,
                                 key=dropout_key)
            losses = optax.softmax_cross_entropy_with_integer_labels(
                logits, labels)
            return jnp.sum(losses * train_mask) / jnp.sum(train_mask)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    print(args)
    print("profile training")
    consts = (graph, features, labels, train_mask)
    carry = (params, opt_state, jnp.float32(0))
    # timing on a throwaway carry; accuracy from EXACTLY n_epochs below
    # (the measurement loop trains many more epochs — utils.run_epochs)
    train_time, _ = time_epoch_loop(train_step, carry, key, args.n_epochs,
                                    warmup=10, consts=consts)
    carry = run_epochs(train_step, carry, key, args.n_epochs, consts=consts)
    params = carry[0]
    max_mb = peak_memory_mb()

    if args.verbose:
        print("final loss", float(carry[2]))

    print("profile inference")

    def infer_step(carry, _key, cs):
        graph, features, _, _ = cs
        # tiny carry-dependence keeps the loop body from being hoisted
        logits = model.apply(params, graph, features + carry * 1e-30)
        return logits[0, 0]

    inference_time, _ = time_epoch_loop(infer_step, jnp.float32(0), key,
                                        args.n_epochs, warmup=3,
                                        consts=consts)
    # graph/features as jit ARGUMENTS (closing over them bakes GBs of graph
    # tables into the executable as constants at Reddit scale)
    logits = jax.jit(lambda p, g, f: model.apply(p, g, f))(params, graph,
                                                           features)

    pred = jnp.argmax(logits, axis=1)
    acc = float(jnp.sum((pred == labels) * test_mask) / jnp.sum(test_mask))
    train_acc = float(jnp.sum((pred == labels) * train_mask) / jnp.sum(train_mask))
    print(f"Test Accuracy {acc:.4f} (train {train_acc:.4f})")
    print(f"max memory:{max_mb:.0f}MB")
    print("train time:", train_time)
    print("inference time:", inference_time)

    if args.output is not None:
        append_csv_row(args.output, f"train_GAT_dgnn_{args.impl}",
                       f"{args.dataset} heads={args.n_heads} hidden_dim={args.n_hidden}",
                       train_time, inference_time, max_mb, acc)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="GAT")
    parser.add_argument("--dataset", type=str, default="cora")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--weight-decay", type=float, default=5e-4)
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--n-epochs", type=int, default=200)
    parser.add_argument("--n-hidden", type=int, default=16)
    parser.add_argument("--n-layers", type=int, default=1)
    parser.add_argument("--n-heads", type=int, default=1)
    parser.add_argument("--negative-slope", type=float, default=0.2)
    parser.add_argument("--attn-drop", type=float, default=0.0)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--impl", type=str, default="fused",
                        choices=["fused", "naive"],
                        help="fused binned kernels vs DGL-style baseline")
    main(parser.parse_args())
