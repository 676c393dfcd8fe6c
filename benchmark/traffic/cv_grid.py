"""Kind `cv_grid`: back-to-back whole calls of the port's MLP
cross-validation (`train.trainer.cross_validate_mlp`), as a user who
retrains on a corpus's feature cache waits for them: every fold x seed of
the grid trained together, then each fold's held-out rows predicted.

Set-up makes the feature table and its folds (gen.feature_rows, gen.folds:
the labels and folds from the mix's shape seed, the features from the
run's seed; the training seed is the run's too) and runs one whole call,
which warms every shape the calls use.  The window runs whole calls until
--seconds have gone by; a call counts G x batch x steps training rows.

The check follows the training object of the window's first call: the
port's `GridTrainer` is wrapped (as corpus_pass wraps its stages), and the
first trainer built in the window records, as its own first three steps
run inside the call: each step's per-entry losses (the port's grid_losses
on the step's own batch and state), its Adam state after the first step
(whose first moment gives the gradient as Adam got it) and its parameters
before the first and after the third step.  The plain reference
(reference/mlp.py, float64) trains the same grid three steps from the
same inputs and seed.  Worked out: the widest gap of the first step's
losses and of all three steps' (`first_loss_gap`, `loss_gap`), and, leaf
by leaf, the gap of the first gradient's norm and of the three steps'
change's norm (`grad_gap`, `change_gap`); the cell's `limits` name the
ones judged, and the others are reported beside them.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import gen  # noqa: E402
import stats  # noqa: E402
import tracing  # noqa: E402
from reference import mlp as ref  # noqa: E402

CHECK_STEPS = 3
QUIET = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


class State:
    pass


def mlp_config(ctx) -> ref.MLPConfig:
    m = ctx.config["mlp"]
    return ref.MLPConfig(hidden=tuple(m["dims"][1:-1]), n_classes=m["dims"][-1],
                         epochs=ctx.params.get("epochs", m["epochs"]),  # a test's smaller call
                         batch_size=m["batch_size"],
                         learning_rate=m["learning_rate"], weight_decay=m["weight_decay"],
                         dropout=m["dropout"], label_smoothing=m["label_smoothing"],
                         n_seeds=m["n_seeds"], seed=ctx.seed % 2**31)


def port_config(cfg: ref.MLPConfig):
    from stutter_tpu_torch.train.trainer import MLPTrainConfig

    return MLPTrainConfig(hidden=cfg.hidden, n_classes=cfg.n_classes, epochs=cfg.epochs,
                          batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
                          weight_decay=cfg.weight_decay, dropout=cfg.dropout,
                          label_smoothing=cfg.label_smoothing, seed=cfg.seed,
                          n_seeds=cfg.n_seeds)


def make_inputs(ctx):
    p = ctx.params
    X, y = gen.feature_rows(ctx.seed, p["table"])
    return X, y, gen.folds(y, ctx.config["mlp"]["folds"], p["table"]["shape_seed"])


def install_recorder(st: State):
    """Wrap the port's GridTrainer so that, while `st.armed`, the next
    trainer built records its first CHECK_STEPS steps; -> undo()."""
    import stutter_tpu_torch.train.trainer as tr

    orig = tr.GridTrainer
    st.records, st.armed, st.steps = [], False, 0

    class Recorded(orig):
        def __init__(self, params, cfg, n_steps):
            super().__init__(params, cfg, n_steps)
            self.rec = None
            if st.armed:
                st.armed = False
                self.rec = {"losses": [], "params0": [p.detach().clone() for p in self._leaves()]}
                st.records.append(self.rec)

        def _leaves(self):
            return [t for pair in zip(self.weights, self.biases) for t in pair]

        def step(self, x, y, w, keeps):
            rec = self.rec
            if rec is not None and self.steps_done < CHECK_STEPS:
                with torch.no_grad():
                    rec["losses"].append(tr.grid_losses(self.weights, self.biases, x, y, w,
                                                        keeps, self.cfg).detach().clone())
            super().step(x, y, w, keeps)
            st.steps += 1
            if rec is not None and self.steps_done == 1:
                state = self.opt.state
                rec["exp_avg"] = [state[p]["exp_avg"].detach().clone() if p in state else None
                                  for p in self._leaves()]
            if rec is not None and self.steps_done == CHECK_STEPS:
                rec["params"] = [p.detach().clone() for p in self._leaves()]

    tr.GridTrainer = Recorded

    def undo():
        tr.GridTrainer = orig

    return undo


def one_call(st: State):
    from stutter_tpu_torch.train.trainer import cross_validate_mlp

    return cross_validate_mlp(st.X, st.y, st.folds, st.cfg, device=st.device)


def setup(ctx) -> State:
    st = State()
    st.device = ctx.device
    st.ref_cfg = mlp_config(ctx)
    st.cfg = port_config(st.ref_cfg)
    st.X, st.y, st.folds = make_inputs(ctx)
    grid = ref.Grid(st.X, st.y, st.folds, st.ref_cfg)
    st.G, st.n_steps = grid.X.shape[0], grid.n_steps
    st.undo = install_recorder(st)
    st.out = one_call(st)
    return st


def window(ctx, st: State) -> dict:
    p = ctx.params
    st.armed, st.steps = True, 0
    calls, t0, ends = 0, time.perf_counter(), []
    while True:
        st.out = one_call(st)
        calls += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= ctx.seconds:
            break
    elapsed = ends[-1] - t0
    steps = st.steps
    rows = steps * st.G * st.cfg.batch_size
    trace = None
    if ctx.trace:
        st.steps = 0
        with tracing.profile_window() as prof:
            with tracing.span(tracing.REGION):
                for _ in range(p["trace_calls"]):
                    st.out = one_call(st)
        trace = tracing.Trace.read(prof, ctx.chips, {
            "steps": st.steps, "rows_per_step": st.G * st.cfg.batch_size,
            "dims": [st.X.shape[1], *st.cfg.hidden, st.cfg.n_classes]})
    call_s = np.diff([t0, *ends])
    return {"metrics": {"train_rows_per_s": stats.rate(rows, elapsed)},
            "attempted": calls, "failed": 0, "trace": trace,
            "detail": {"calls": calls, "steps": steps, "elapsed_s": elapsed,
                       "call_s": {"min": float(call_s.min()), "median": float(np.median(call_s)),
                                  "max": float(call_s.max())}}}


def release(ctx, st: State) -> None:
    """The records move to the host; the program's outputs and trainers go."""
    st.undo()
    st.records = [{k: ([t.double().cpu() if t is not None else None for t in v]
                       if isinstance(v, list) else v) for k, v in r.items()}
                  for r in st.records]
    st.out = None


def leaf_gap(got: list, want: list, judged: list) -> float:
    """The worst judged leaf's gap of norms, |‖got‖ - ‖want‖|, over the
    larger of the reference leaf's norm and the median leaf's."""
    norms = [float(w.norm()) for w in want]
    med = float(np.median(norms))
    return max(abs(float(g.norm()) - n) / max(n, med)
               for g, n, j in zip(got, norms, judged) if j)


def gaps(rec: dict, want: dict) -> dict:
    """The program's record against the reference's first steps."""
    beta1 = ref.BETAS[0]
    got_l, want_l = torch.stack(rec["losses"]), want["losses"]
    grad = [m / (1.0 - beta1) if m is not None else torch.zeros_like(w)
            for m, w in zip(rec["exp_avg"], want["grad"])]
    gn = [float(g.norm()) for g in want["grad"]]
    judged = [n >= QUIET * float(np.median(gn)) for n in gn]
    change = [a - b for a, b in zip(rec["params"], rec["params0"])]
    want_change = [a - b for a, b in zip(want["params"], want["params0"])]
    rel = (got_l - want_l).abs() / want_l.abs()  # [steps, G]
    return {"loss_gap": float(rel.max()), "first_loss_gap": float(rel[0].max()),
            "grad_gap": leaf_gap(grad, want["grad"], judged),
            "change_gap": leaf_gap(change, want_change, judged),
            "quiet_leaves": [i for i, j in enumerate(judged) if not j]}


def reference_steps(ctx, st: State, dtype=torch.float64) -> dict:
    grid = ref.Grid(st.X, st.y, st.folds, st.ref_cfg)
    return ref.first_steps(grid, CHECK_STEPS, ctx.device, dtype)


def compare(ctx, st: State) -> list[dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lim = ctx.params["limits"]
    recs = [r for r in st.records if "params" in r]
    if not recs:  # the window's first trainer never reached its third step
        return [{"name": k, "value": float("inf"), "limit": lim[k], "ok": False} for k in lim]
    g = gaps(recs[0], reference_steps(ctx, st))
    st.notes = {k: v for k, v in g.items() if k not in lim}  # reported, not judged
    return [{"name": k, "value": g[k], "limit": lim[k], "ok": g[k] <= lim[k]} for k in lim]


def control(ctx, seeds: list[int], n=None, fault: str | None = None) -> list[dict]:
    """The control on each seed: the reference in float32 with TF32 on, in
    the program's place, judged against the float64 reference.  With
    `fault="half_batch"`, the float64 reference in the program's place
    takes each step's loss over half of its batch."""
    out = []
    for seed in seeds:
        ctx.seed = seed
        st = State()
        st.ref_cfg = mlp_config(ctx)
        st.X, st.y, st.folds = make_inputs(ctx)
        torch.backends.cuda.matmul.allow_tf32 = False
        want = reference_steps(ctx, st)
        if fault == "half_batch":
            grid = ref.Grid(st.X, st.y, st.folds, st.ref_cfg)
            low = ref.first_steps(grid, CHECK_STEPS, ctx.device, torch.float64,
                                  rows_used=st.ref_cfg.batch_size // 2)
        else:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                low = reference_steps(ctx, st, torch.float32)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        rec = {"losses": list(low["losses"]), "exp_avg": [(1.0 - ref.BETAS[0]) * g
                                                          for g in low["grad"]],
               "params0": low["params0"], "params": low["params"]}
        g = gaps(rec, want)
        g.pop("quiet_leaves")
        out.append({"seed": seed, **g})
    return out
