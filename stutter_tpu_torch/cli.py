"""Command-line interface of the port:

  python -m stutter_tpu_torch preprocess   --root WORKDIR   # clean + QC csv
  python -m stutter_tpu_torch extract      --root WORKDIR [--suffix raw|clean|both]
  python -m stutter_tpu_torch predict FILE --root WORKDIR [--no-denoise]

Every subcommand takes --variant {149,334} (the feature contract; 334 is the
main.py variant, 286 dims computed), --prop-decrease (the gate's
attenuation: 1.0 is the pipeline1 protocol and the default, 0.8 the main.py
protocol) and --device {cuda,cpu} (cuda, the default, raises when there is
no GPU).  The workspace layout and every file written are the JAX
package's (`python -m stutter_tpu`), so the two CLIs share workspaces.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="stutter_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("--root", default=".", help="workspace with segrigated_samples/ etc.")
        p.add_argument("--variant", default="149", choices=["149", "334"])
        p.add_argument("--prop-decrease", type=float, default=None,
                       help="spectral-gate attenuation fraction: 1.0 = the pipeline1 "
                            "protocol (default), 0.8 = the main.py protocol")
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="device to run on; cuda raises when there is no GPU")

    add_common(sub.add_parser("preprocess", help="denoise the corpus + per-file QC analysis"))
    p = sub.add_parser("extract", help="(re)generate the feature cache")
    add_common(p)
    p.add_argument("--suffix", default="clean", choices=["raw", "clean", "both"])
    p = sub.add_parser("predict", help="classify one audio file")
    add_common(p)
    p.add_argument("file")
    p.add_argument("--no-denoise", action="store_true")
    args = ap.parse_args(argv)

    from stutter_tpu_torch.config import FEATURES_149, FEATURES_334, PipelineConfig
    from stutter_tpu_torch.device import resolve_device

    resolve_device(args.device)  # cuda without a GPU raises before anything is written
    cfg = PipelineConfig(features=FEATURES_334 if args.variant == "334" else FEATURES_149)
    if args.prop_decrease is not None:
        cfg = dataclasses.replace(
            cfg, denoise=dataclasses.replace(cfg.denoise, prop_decrease=args.prop_decrease))
    out_dir = os.path.join(args.root, cfg.data.output_dir)

    if args.cmd == "preprocess":
        from stutter_tpu_torch.pipeline import preprocess, setup_logging

        setup_logging(out_dir)
        rows = preprocess(args.root, cfg, device=args.device)
        print(f"processed {len(rows)} files -> per_file_analysis.csv")
    elif args.cmd == "extract":
        from stutter_tpu_torch.pipeline import extract_corpus, setup_logging

        setup_logging(out_dir)
        for sfx in (["raw", "clean"] if args.suffix == "both" else [args.suffix]):
            X, _, _, ok = extract_corpus(args.root, cfg, sfx, device=args.device)
            extra = "" if ok.all() else f" ({int((~ok).sum())} rows failed decode)"
            print(f"{sfx}: {int(ok.sum())} vectors x {X.shape[1]} dims cached{extra}")
    else:
        from stutter_tpu_torch.infer import Predictor

        pred = Predictor.load(out_dir, cfg, device=args.device)
        pred.denoise_first = not args.no_denoise
        print(json.dumps(pred.predict_file(args.file), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
