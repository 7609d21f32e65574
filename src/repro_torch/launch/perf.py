"""Knob-variant harness over the dry run (port of ``repro/launch/perf.py``):
re-run a cell under named knob variants and report the roofline-term
deltas against the baseline.

    PYTHONPATH=src python -m repro_torch.launch.perf --cell yi-9b:decode_32k \
        --variant baseline --variant bf16_scores --out results/perf_torch_yi.json

``VARIANTS`` keeps the JAX names. Every variant runs (the train-side
ones, remat, accum and zero1, on a ``train_4k`` cell; the ``kv_shard``
ones cut a serving cell's dense caches by position, launch/dryrun.py).
The terms are a model against the H100's peaks (launch/op_cost.py).

    PYTHONPATH=src python -m repro_torch.launch.perf --cell yi-9b:train_4k \
        --variant baseline --variant zero1 --variant accum4_dots
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

VARIANTS = {
    "baseline": {},
    "bf16_scores": {"score_dtype": "bf16_mxu"},
    "kv_seq_shard": {"score_dtype": "bf16_mxu", "kv_shard": "seq_model"},
    "kv_seq_shard_f32": {"kv_shard": "seq_model"},
    "no_remat": {"remat": "none"},
    "remat_dots": {"remat": "dots"},
    "accum4": {"accum": 4},
    "accum4_dots": {"accum": 4, "remat": "dots"},
    "zero1": {"zero1": True},
    "pad_heads": {"pad_heads_to": 16},
    "pad_heads_bf16": {"pad_heads_to": 16, "score_dtype": "bf16_mxu"},
    "pad_heads_full": {"pad_heads_to": 16, "score_dtype": "bf16_mxu",
                       "kv_shard": "seq_model"},
    "zero1_dots": {"zero1": True, "remat": "dots"},
    "chunk512": {"attn_chunk": 512},
    "chunk8k": {"attn_chunk": 8192},
    "act_exact": {"act_impl": "exact"},
    "act_pallas": {"act_impl": "cordic_pallas"},
    "act_float": {"act_impl": "cordic_float"},
    "slstm_rep": {"slstm_state": "replicated"},
    "mlstm_chunk128": {"mixer_chunk": 128},
    "mlstm_chunk64": {"mixer_chunk": 64},
    "xlstm_best": {"slstm_state": "replicated", "mixer_chunk": 128},
    "accum4_fixed": {"accum": 4},
    "slstm_rep_dots": {"slstm_state": "replicated", "remat": "dots"},
}


def run_variants(arch: str, shape_name: str, names, multi_pod: bool = False,
                 **cell_kw):
    """[record] of each variant of one cell (``lower_cell`` kwargs from
    ``VARIANTS``; a refused variant's record has status "error" and its
    reason)."""
    from repro_torch.launch.dryrun import lower_cell

    results, base_terms = [], None
    for name in names:
        kw = VARIANTS[name]
        try:
            rec = lower_cell(arch, shape_name, multi_pod=multi_pod, **kw, **cell_kw)
            rec["variant"], rec["knobs"] = name, kw
            if rec["status"] != "ok":
                print(f"[perf] {arch}:{shape_name} {name}: {rec['status']} "
                      f"{rec.get('reason')}")
                results.append(rec)
                continue
            t = rec["roofline"]
            line = (f"[perf] {arch}:{shape_name} {name:18s} "
                    f"compute {t['compute_s']:.3e}  memory {t['memory_s']:.3e}  "
                    f"coll {t['collective_s']:.3e}  dom={t['dominant']}")
            if base_terms is None and name == "baseline":
                base_terms = t
            elif base_terms is not None:
                d = base_terms[base_terms["dominant"]]
                n = t[base_terms["dominant"]]
                line += f"  [dominant-term delta vs baseline: {100 * (1 - n / d):+.1f}%]"
            print(line)
        except Exception as e:                               # noqa: BLE001
            rec = {"variant": name, "arch": arch, "shape": shape_name,
                   "status": "error", "error": repr(e),
                   "trace": traceback.format_exc()[-1500:]}
            print(f"[perf] {arch}:{shape_name} {name}: FAILED {e!r}")
        results.append(rec)
        sys.stdout.flush()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", action="append", required=True,
                    choices=list(VARIANTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    arch, shape = args.cell.split(":")
    results = run_variants(arch, shape, args.variant, args.multi_pod)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
