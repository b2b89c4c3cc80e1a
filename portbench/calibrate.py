"""Read the numbers that the check's limit is set from, at a cell's own
size, in one process: the program's step gaps over many seeds and the
controls' over some: the reference in the program's place with TF32 on
(the control) and with its state stored in bfloat16.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,...
        [--control-seeds 1,2,3] [--window-steps 40] [--out FILE]

For each seed: the program's model (built once) steps from the seed's
initial state through the traffic's warm-up and a short free-running
window of `--window-steps` steps (its two compared steps drawn from the
seed as a run draws them), and the reference (built once) reads the
start, the first step and the two window steps, as portbench/run.py
does.  For each control seed it also reads both controls at the same
inputs.  Prints one JSON object, and writes it to `--out`.  The
benchmark's runs do not run this.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = _ROOT
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def readings(cell, seeds, control_seeds, window_steps: int, device) -> dict:
    from portbench import compare, drive

    cfg, traffic = cell.config, cell.traffic
    fields = compare.compared_fields(cfg)
    if window_steps <= traffic["pick_steps"]:
        raise ValueError("the window must hold the traffic's pick_steps")
    model = drive.build_program(cfg, device)
    ref = compare.build_reference(cfg, device)
    out = {"workload": cell.name, "window_steps": window_steps,
           "program": {}, "control": {}}
    for seed in seeds:
        t = time.perf_counter()
        state = drive.initial_state(model, traffic, seed)
        warm = drive.free_run(model, state, traffic,
                              steps=traffic["warmup_steps"], hold=(0,))
        picks = drive.picks(traffic, seed)
        win = drive.free_run(model, warm.state, traffic, steps=window_steps,
                             hold=picks)
        steps = compare.compared_steps(warm.held, win.held)
        out["program"][str(seed)] = compare.gap_table(ref, traffic, seed,
                                                      steps, fields)
        if seed in control_seeds:
            out["control"][str(seed)] = {
                kind: {name: compare.control_gaps(ref, inp, fields, kind)
                       for name, (inp, _) in steps}
                for kind in ("tf32", "bf16")}
        del warm, win, steps, state
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    worst = lambda rows: {s: max(max(g.values()) for g in r.values()
                                 if isinstance(g, dict))
                          for s, r in rows.items()}
    out["program_worst"] = worst(out["program"])
    out["control_worst"] = {
        kind: worst({s: r[kind] for s, r in out["control"].items()})
        for kind in ("tf32", "bf16")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--window-steps", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("portbench/calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    out = readings(spec.cell(args.workload), seeds, control or seeds[:1],
                   args.window_steps, "cuda:0")
    out["card"] = torch.cuda.get_device_name(0)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
