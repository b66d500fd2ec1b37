"""End-to-end ELSA (Alg. 1) on the PyTorch port: behavior-aware
clustering -> dynamic-split LoRA fine-tuning through the SS-OP∘sketch
channel -> coherence/trust-weighted cloud fusion.

  PYTHONPATH=src python examples/torch_elsa_federated_finetune.py \
      [--rounds 8] [--clients 10] [--method elsa] [--full] \
      [--device cuda|cpu] [--backend batched|reference] [--model llama3-8b]

The flags of ``examples/elsa_federated_finetune.py`` (the JAX package's
example), plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions of the kernels).  ``--backend batched`` (the default) runs each
local round through the batched engine over the stacked clients,
``--backend reference`` the sequential loop; ``--model`` takes any
registered split model, the dense causal LMs (llama3-8b, olmo-1b, the
qwen configs) included.  The scalar history is written with the port's
``checkpoint.save`` to ``<out>/<method>_history.msgpack``, in the JAX
package's checkpoint format (either package's ``restore`` reads it).
"""
import argparse
import os

from repro_torch.checkpoint import save
from repro_torch.federation.simulation import FedConfig, Federation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="elsa",
                    choices=["elsa", "elsa-fixed", "elsa-nocluster",
                             "fedavg", "fedavg-random", "fedprox", "fedams"])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--edges", type=int, default=3)
    ap.add_argument("--alpha", type=float, default=None,
                    help="Dirichlet label-skew concentration (default "
                         "0.1; --tuned defaults to 5.0 unless given)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--model", default="bert-base",
                    help="registered split-model name")
    ap.add_argument("--backend", default="batched",
                    choices=["batched", "reference"])
    ap.add_argument("--aggregate", default="product",
                    choices=["product", "factor"],
                    help="LoRA aggregation space")
    ap.add_argument("--tuned", action="store_true",
                    help="convergence stack: clipping, per-group lrs, "
                         "mean-pool readout, FedAdam server step")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="runs/elsa_finetune")
    args = ap.parse_args(argv)

    alpha = args.alpha if args.alpha is not None \
        else (5.0 if args.tuned else 0.1)
    if args.full:
        kw = dict(n_clients=20, n_edges=4, alpha=alpha,
                  poisoned=(3, 8, 12, 17), total_examples=4000,
                  layers=8, lr=2e-2, t_rounds=2, model=args.model)
    else:
        kw = dict(n_clients=args.clients, n_edges=args.edges,
                  alpha=alpha, poisoned=(2,),
                  total_examples=1500, probe_q=16,
                  local_warmup_steps=4, layers=4, lr=2e-2,
                  t_rounds=1, model=args.model)
    kw["aggregate"] = args.aggregate
    if args.tuned:
        lm = args.model != "bert-base"
        kw.update(clip_norm=1.0, seq_len=32,
                  class_sharpness=10.0, background_frac=0.0,
                  server_opt="fedadam", server_lr=0.03)
        kw.update(dict(lr=0.5, vocab_size=32) if lm
                  else dict(lr=5e-3, head_lr=0.4, pooling="mean"))
    cfg = FedConfig(**kw)
    fed = Federation(cfg, backend=args.backend, device=args.device)

    print(f"== phase 1: profiling {cfg.n_clients} clients ==")
    div, trust, cres, _ = fed.profile_clients()
    for k, members in cres.groups.items():
        if members:
            print(f"  edge {k}: clients {members} "
                  f"(mean trust {trust[members].mean():.3f})")
    if cres.escalated:
        print(f"  escalated to cloud: {cres.escalated}")
    if cres.excluded:
        print(f"  excluded: {cres.excluded}")

    print(f"== phases 2-3: {args.method} for {args.rounds} rounds ==")
    hist = fed.run(args.method, global_rounds=args.rounds,
                   steps_per_round=args.steps, log=True)

    os.makedirs(args.out, exist_ok=True)
    scalar_hist = {k: list(map(float, v)) if isinstance(v, list)
                   else float(v) for k, v in hist.items()
                   if isinstance(v, (list, int, float))}
    save(os.path.join(args.out, f"{args.method}_history.msgpack"),
         scalar_hist)
    print(f"final accuracy: {hist['final_accuracy']:.4f} "
          f"(history -> {args.out})")
    return hist


if __name__ == "__main__":
    main()
