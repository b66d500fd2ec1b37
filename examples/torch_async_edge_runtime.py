"""Wall-clock federation on the PyTorch port's event-driven edge runtime.

Runs the same reduced-BERT federation under one or all scheduler
policies and prints accuracy-vs-simulated-time, per-policy event
statistics, and (with ``--policy all``) the time-to-training-loss
comparison:

  PYTHONPATH=src python examples/torch_async_edge_runtime.py \
      [--policy all|sync|deadline|async] [--method elsa-nocluster] \
      [--clients 10] [--rounds 4] [--churn] [--constrained 0.3] \
      [--device cuda|cpu]

The flags of ``examples/async_edge_runtime.py`` (the JAX package's
example), plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions of the kernels).  ``--churn`` switches on the dropout/rejoin
availability model; with ``--constrained`` a fraction of devices gets
throttled compute and uplink (the paper's heterogeneous-device setup).
Try ``--policy all --churn`` to watch sync pay the straggler barrier
while deadline and async don't.
"""
import argparse

from repro_torch.federation.simulation import FedConfig, Federation
from repro_torch.federation.topology import make_churn_trace
from repro_torch.runtime import RuntimeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="all",
                    choices=["all", "sync", "deadline", "async"])
    ap.add_argument("--method", default="elsa-nocluster")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--edges", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--churn", action="store_true")
    ap.add_argument("--constrained", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    fed_kw = dict(n_clients=args.clients, n_edges=args.edges, alpha=0.2,
                  poisoned=(2,), total_examples=1500, probe_q=16,
                  local_warmup_steps=4, layers=4, lr=2e-2,
                  t_rounds=1, constrained_frac=args.constrained)
    churn = None
    if args.churn:
        churn = make_churn_trace(args.clients, 1e6, mean_on_s=30.0,
                                 mean_off_s=12.0, churn_frac=0.5, seed=7)

    policies = (["sync", "deadline", "async"] if args.policy == "all"
                else [args.policy])
    curves = {}
    for policy in policies:
        fed = Federation(FedConfig(**fed_kw), device=args.device)
        h = fed.run(args.method, global_rounds=args.rounds,
                    steps_per_round=args.steps,
                    runtime=RuntimeConfig(policy=policy, churn=churn))
        curves[policy] = h
        print(f"\n== {policy} ==  (trace: {h['trace'].summary()})")
        print(f"  {'sim time':>10}  {'accuracy':>8}  {'loss':>8}")
        for t, a, l in zip(h["time"], h["accuracy"], h["loss"]):
            print(f"  {t:9.1f}s  {a:8.4f}  {l:8.4f}")

    if len(curves) > 1:
        # training-loss crossing: progress per simulated second (test
        # accuracy stays near chance on the synthetic corpus)
        target = 1.01 * max(min(h["loss"]) for h in curves.values())
        print(f"\n== time to training loss {target:.4f} ==")
        for policy, h in curves.items():
            tt = next((t for t, l in zip(h["time"], h["loss"])
                       if l <= target), None)
            print(f"  {policy:9s} {'—' if tt is None else f'{tt:9.1f}s'}")


if __name__ == "__main__":
    main()
