"""Command-line interface of the port:

  python -m stutter_tpu_torch predict FILE --root WORKDIR [--no-denoise] [--device cuda]

classifies one audio file with the artifacts in WORKDIR/output_results (as
the JAX package's `train` writes them) and prints the label and the class
probabilities as JSON.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="stutter_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("predict", help="classify one audio file")
    p.add_argument("file")
    p.add_argument("--root", default=".", help="workspace holding output_results/")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device to serve on; cuda raises when there is no GPU")
    args = ap.parse_args(argv)

    from stutter_tpu.config import PipelineConfig
    from stutter_tpu_torch.infer import Predictor

    cfg = PipelineConfig()
    pred = Predictor.load(os.path.join(args.root, cfg.data.output_dir), cfg, device=args.device)
    pred.denoise_first = not args.no_denoise
    print(json.dumps(pred.predict_file(args.file), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
