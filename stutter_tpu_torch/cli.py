"""Command-line interface of the port:

  python -m stutter_tpu_torch preprocess   --root WORKDIR   # clean + QC csv
  python -m stutter_tpu_torch extract      --root WORKDIR [--suffix raw|clean|both]
  python -m stutter_tpu_torch train        --root WORKDIR [--no-host] [--features F] [--labels L]
                                           [--seq [--seq-seeds N] [--ensemble-mlp M] ...]
  python -m stutter_tpu_torch train-ab     --root WORKDIR   # before/after cleaning (engine A)
  python -m stutter_tpu_torch train-seq    --root WORKDIR [--arch A] [--epochs E] [--ckpt]
  python -m stutter_tpu_torch predict FILE --root WORKDIR [--no-denoise] [--arch ARCH]
  python -m stutter_tpu_torch stream  FILE --root WORKDIR [--window S --hop S] [--arch mlp|ensemble]
  python -m stutter_tpu_torch serve        --root WORKDIR [--port P] [--ensemble] [--seq-arch A]

Every subcommand takes --variant {149,334} (the feature contract; 334 is the
main.py variant, 286 dims computed), --prop-decrease (the gate's
attenuation: 1.0 is the pipeline1 protocol and the default, 0.8 the main.py
protocol) and --device {cuda,cpu} (cuda, the default, raises when there is
no GPU).  The workspace layout and every file written are the JAX
package's (`python -m stutter_tpu`), so the two CLIs share workspaces.
`train` is engine B: the feature MLP (5-fold CV table, the persisted
model, permutation importance), the sklearn zoo where sklearn is
installed, and with --seq the sequence heads' CV grids, their weighted
vote and the servable quint (refit heads + ensemble.json).  `train-seq`
trains one sequence head on the 80/20 split, --ckpt checkpointing and
resuming its training state (the port's own torch.save format, not Orbax).
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
    p = sub.add_parser("train", help="5-fold CV table + persist the production MLP (engine B)")
    add_common(p)
    p.add_argument("--no-host", action="store_true", help="skip the sklearn baselines")
    p.add_argument("--features", default="clean", choices=["clean", "raw", "both"])
    seq_archs = ["cnn", "cnn_bilstm", "transformer", "transformer_lr1e3",
                 "transformer_mix4_lr1e3"]
    p.add_argument("--seq", action="store_true",
                   help="also CV the CNN/CNN-BiLSTM/transformer heads")
    p.add_argument("--seq-seeds", type=int, default=1,
                   help="soft-vote the sequence heads over N seeds (at Nx the training cost)")
    p.add_argument("--labels", default="folder", choices=["folder", "5class"],
                   help="label taxonomy: corpus folders or the 5-class dysfluency set")
    p.add_argument("--ensemble-mlp", default="none", choices=["none", "both", "clean"],
                   help="MLP member of the weighted vote: none (default), raw+clean "
                        "concatenation, or clean-only")
    p.add_argument("--seq-tta-crop", type=int, default=0,
                   help="prediction-time augmentation comparison: also score each seq head "
                        "and the vote with start/end-cropped views of this many frames "
                        "averaged in (extra +TTA rows; artifacts stay baseline)")
    p.add_argument("--seq-balanced", action="store_true",
                   help="train sequence members with inverse-class-frequency minibatch "
                        "sampling (a macro-recall knob; not the production default)")
    p.add_argument("--seq-raw-arch", action="append", default=[], choices=seq_archs,
                   help="diversity probe: also train this arch on the raw (pre-denoise) "
                        "decode of the same clips as a vote member '<arch>_raw'; repeatable; "
                        "probe-only (use a scratch workspace: not servable)")
    add_common(sub.add_parser("train-ab", help="before/after cleaning comparison (engine A)"))
    p = sub.add_parser("train-seq", help="train one sequence head (CNN / CNN-BiLSTM / "
                                         "transformer)")
    add_common(p)
    p.add_argument("--arch", default="cnn_bilstm", choices=seq_archs)
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--mixup", type=float, default=None,
                   help="mixup alpha (default: the arch's recipe, 0.2 for the log-mel "
                        "heads, 0.0 for cnn_bilstm)")
    p.add_argument("--ckpt", action="store_true",
                   help="checkpoint the training state and resume from it")
    p.add_argument("--labels", default="folder", choices=["folder", "5class"],
                   help="label taxonomy: corpus folders or the 5-class dysfluency set")
    p = sub.add_parser("predict", help="classify one audio file")
    add_common(p)
    p.add_argument("file")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--arch", default="mlp", choices=["mlp", *seq_archs, "ensemble"],
                   help="serving head: the feature-MLP, a trained sequence head, or the "
                        "weighted-vote ensemble (the headline model)")
    p = sub.add_parser("stream", help="windowed streaming inference over a long file")
    add_common(p)
    p.add_argument("file")
    p.add_argument("--window", type=float, default=3.0)
    p.add_argument("--hop", type=float, default=1.0)
    p.add_argument("--arch", default="mlp", choices=["mlp", "ensemble"])
    p = sub.add_parser("serve", help="HTTP inference service (POST /predict, /stream)")
    add_common(p)
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (0.0.0.0 to expose externally)")
    p.add_argument("--seq-arch", action="append", default=[], choices=seq_archs,
                   help="also serve this sequence head (POST /predict?model=<arch>); "
                        "repeatable")
    p.add_argument("--ensemble", action="store_true",
                   help="also serve the weighted-vote ensemble (POST /predict?model=ensemble)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every model at every clip bucket before binding")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="micro-batch concurrent /predict requests to batch-capable models "
                        "(the ensemble) within this window; 0 = off")
    p.add_argument("--batch-max", type=int, default=8,
                   help="max clips per micro-batched pass")
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
    elif args.cmd == "train":
        from stutter_tpu_torch.pipeline import run_cv, setup_logging

        setup_logging(out_dir)
        res = run_cv(args.root, cfg, include_host=not args.no_host, feature_set=args.features,
                     include_seq=args.seq, labels_taxonomy=args.labels,
                     seq_seeds=args.seq_seeds, ensemble_mlp=args.ensemble_mlp,
                     seq_tta_crops=(args.seq_tta_crop,) if args.seq_tta_crop else (),
                     seq_raw_archs=tuple(args.seq_raw_arch),
                     seq_class_balanced=args.seq_balanced, device=args.device)
        for row in res["final_rows"]:
            print(f'{row["Model"]:14s} acc={row["Accuracy (%)"]:.1f}% '
                  f'P={row["Precision (%)"]:.1f} R={row["Recall (%)"]:.1f} '
                  f'F1={row["F1-Score (%)"]:.1f}')
    elif args.cmd == "train-ab":
        from stutter_tpu_torch.pipeline import run_before_after, setup_logging

        setup_logging(out_dir)
        for m in run_before_after(args.root, cfg, device=args.device)["metrics"]:
            print(f'{m["dataset"]:7s} {m["model"]:14s} acc={m["accuracy"]:.2f}% '
                  f'loss={m["test_loss"]:.4f}')
    elif args.cmd == "train-seq":
        from stutter_tpu_torch.train.seq_pipeline import default_train_cfg, run_seq

        tc = default_train_cfg(args.arch, args.epochs)
        if args.mixup is not None:
            tc = dataclasses.replace(tc, mixup_alpha=args.mixup)
        res = run_seq(args.root, args.arch, cfg, tc, ckpt=args.ckpt,
                      labels_taxonomy=args.labels, device=args.device)
        print(f'{res["arch"]}: acc={res["accuracy"]:.1f}% loss={res["test_loss"]:.3f} '
              f'[{res["elapsed_s"]:.0f}s]')
    elif args.cmd == "predict":
        from stutter_tpu_torch.infer import EnsemblePredictor, Predictor, SeqPredictor

        if args.arch == "mlp":
            pred = Predictor.load(out_dir, cfg, device=args.device)
        elif args.arch == "ensemble":
            pred = EnsemblePredictor.load(out_dir, cfg, device=args.device)
        else:
            pred = SeqPredictor.load(out_dir, args.arch, cfg, device=args.device)
        pred.denoise_first = not args.no_denoise
        print(json.dumps(pred.predict_file(args.file), indent=2))
    elif args.cmd == "stream":
        from stutter_tpu_torch.infer import EnsemblePredictor, Predictor
        from stutter_tpu_torch.io.decode import decode_audio

        pred = (EnsemblePredictor.load(out_dir, cfg, device=args.device)
                if args.arch == "ensemble" else Predictor.load(out_dir, cfg, device=args.device))
        sr = cfg.features.frontend.sample_rate
        y = decode_audio(args.file, sr, device=args.device)
        for w in pred.predict_stream(y, sr, window_s=args.window, hop_s=args.hop):
            print(f'{w["start_s"]:7.2f}-{w["end_s"]:7.2f}s  {w["label"]}')
    else:
        from stutter_tpu_torch.serve import serve

        httpd = serve(out_dir, cfg, args.port, warmup=not args.no_warmup, host=args.host,
                      seq_arches=tuple(args.seq_arch), ensemble=args.ensemble,
                      batch_window_ms=args.batch_window_ms, batch_max=args.batch_max,
                      device=args.device)
        print(f"serving on {args.host}:{args.port} (POST /predict, /stream; GET /healthz)",
              flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
