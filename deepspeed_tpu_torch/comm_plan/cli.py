"""``comm-plan``: inspect recorded collective plans (counterpart of
``deepspeed_tpu/comm_plan/cli.py``; the launcher runner's ``comm-plan``
subcommand).

``show`` renders a plan JSON (and, with ``--query``, what the plan or the
heuristic resolves for one message) without touching a device. ``sweep``
records the (op x algo x size) grid through the collective benchmark and
the autotuner, which the port does not have yet (ROADMAP item 5.3): it
raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dstpu comm-plan",
        description="record collective sweeps / select + inspect comm "
                    "plans (docs/COMM.md)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sw = sub.add_parser("sweep", help="run the op x algo x size grid on "
                                      "this host's devices and write the "
                                      "selected plan")
    sw.add_argument("--ops", default="all_reduce,all_gather,"
                                     "reduce_scatter,all_to_all")
    sw.add_argument("--algos", default="exact,int8,overlap,overlap_int8")
    sw.add_argument("--sizes-mb", default="1,4,16,64")
    sw.add_argument("--dtype", default="float32")
    sw.add_argument("--iters", type=int, default=10)
    sw.add_argument("--mesh", default="")
    sw.add_argument("--out", default="comm_plan.json")
    sw.add_argument("--record", default="")

    sh = sub.add_parser("show", help="render a recorded plan")
    sh.add_argument("plan", help="plan JSON path")
    sh.add_argument("--query", default="",
                    help="kind:axis:bytes — print the algorithm this "
                         "plan (entry or heuristic) resolves for one "
                         "message, e.g. reduce_scatter:data:8388608")

    args = p.parse_args(argv)
    if args.cmd == "sweep":
        raise NotImplementedError(
            "comm-plan sweep needs the collective benchmark "
            "(benchmarks/communication.py) and the autotuner (autotuning/), "
            "which are not ported to deepspeed_tpu_torch yet (see "
            "ROADMAP.md item 5.3); record a plan with the JAX package's "
            "sweep or write one by hand")
    from .plan import CommPlan
    plan = CommPlan.load(args.plan)
    print(plan.describe())
    if args.query:
        from .selector import heuristic_algo
        kind, axis, nbytes = args.query.split(":")
        chosen = plan.choose(kind, axis, int(nbytes))
        if chosen is None:
            chosen = heuristic_algo(kind, int(nbytes), axis_size=2)
            print(f"{args.query} -> {chosen} (heuristic: no plan "
                  "entry covers this bucket)")
        else:
            print(f"{args.query} -> {chosen} (plan entry)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
