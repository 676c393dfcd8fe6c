"""chip_smoke.py phase 8's fed-step check, on the CPU: the CPU's FP32
GridTrainer stands in for the card.  Published widths (149-256-128-64-3,
batch 128, dropout 0.2), ten fed steps, Gaussian features from numpy
seeds.

Each step is held on its own, from the state of an FP64 run of the same
steps, to FP64: the loss (relative 1e-5) and the gradients (1e-4 normwise,
per grid entry and tensor, over a tenth of the terms' summed magnitude
where the gradient cancels below that) with the card's sign at the ReLU
gates that rounding decides, and Adam's update given the card's gradient (1e-4).  The
chained check it replaces held ten FP32 steps to another run's within 1e-4
normwise per tensor, all entries stacked.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from stutter_tpu_torch.train import trainer
from stutter_tpu_torch.train.trainer import MLPTrainConfig

torch.set_num_threads(2)

CFG = MLPTrainConfig()
CPU = torch.device("cpu")
STEPS = 10
FAULTY = 1  # the grid entry a planted fault acts on


def fed_data(seed: int, G: int, N: int = 724):
    """Phase 8's fed inputs at G entries of N rows: Gaussian features in
    place of the corpus's standardized ones."""
    rng = np.random.RandomState(seed)
    X = rng.randn(G, N, 149).astype(np.float32)
    y = rng.randint(0, 3, (G, N))
    idx = rng.randint(0, N, (STEPS, G, CFG.batch_size))
    keeps = [[rng.rand(G, CFG.batch_size, h) < 1 - CFG.dropout for h in CFG.hidden]
             for _ in range(STEPS)]
    return X, y, idx, keeps, [CFG.seed + s % CFG.n_seeds for s in range(G)]


def chained_distance(a, b) -> float:
    """The old check's reading: the largest normwise relative distance, per
    tensor with all entries stacked, between two trainers' parameters (NaN
    where one is NaN)."""
    pb = b.params()
    return float(np.max([chip_smoke.step_errors(v.double().numpy(), pb[k].double().numpy())["rel"]
                         for k, v in a.params().items()]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_each_fp32_step_equals_fp64_with_rounding_decided_gates(seed):
    """G = 40.  The new check passes on every seed: gradients within ~8e-7,
    updates within ~1.5e-5, losses within ~3e-7, a few rounding-decided
    gates per entry-step.  Held to its own norm alone, the worst gradient
    is b3's, at 1.7e-6 to 4.1e-6: a batch mean of softmax minus target,
    it cancels to below GRAD_FLOOR of its terms' sum, over which its error
    is then taken.  On seeds 2 and 3 a flagged gate takes the other
    sign in FP32 at some step, and FP64's own sign there would put the
    gradient off by 8.8e-4 and 2.0e-2.  The old chained check, FP32 against
    FP64 over the same ten steps, reads 1.6e-6, 1.3e-4, 1.6e-4 and 5.2e-4 on
    seeds 0-3: it refuses this correct FP32 run on three of them (asserted
    on seed 3, five times over its bound)."""
    data = fed_data(seed, 40)
    steps, exact = chip_smoke.check_fed_steps(CPU, *data, CFG)
    assert len(steps) == STEPS
    for s in steps:
        assert s["ok"] and s["bitwise"], s
        assert s["grad"]["max"] < 2e-6 and s["update"]["max"] < 5e-5 and s["loss"]["max"] < 2e-6
        assert 0 < s["flagged"] and s["flagged_max_entry"] < 20, s
    worst = max((s["grad_normwise"] for s in steps), key=lambda r: r["max"])
    assert worst["tensor"] == "b3" and worst["cancel"] < chip_smoke.GRAD_FLOOR, worst
    if seed == 3:
        assert sum(s["flipped"] for s in steps) >= 1
        assert max(s["grad_plain_max"] for s in steps) > 1e-4
        fp32, _ = chip_smoke.fed_steps(CPU, *data, CFG)
        assert chained_distance(fp32, exact) > 1e-4


def plant_tie(X, y, idx, keeps, seeds, entry: int = 0):
    """Move one feature of one of step 0's batch rows of `entry` so that a
    kept layer-0 pre-activation lies within 1e-9 of zero in FP64 and the
    FP32 chain gives it the other sign -> the new X and the gate's (row,
    unit)."""
    params = trainer.init_grid(seeds, X.shape[-1], CFG, "cpu")
    w0 = params["w0"][entry].double().numpy()
    batch = chip_smoke.fed_batch(X, y, idx, keeps, 0, CPU)
    for r in range(CFG.batch_size):
        n = idx[0][entry, r]
        row = X[entry, n].astype(np.float64)
        for j in np.flatnonzero(keeps[0][0][entry, r]):
            m = int(np.abs(w0[:, j]).argmax())
            c = np.float32(row[m] - row @ w0[:, j] / w0[m, j])
            for _ in range(4):  # c and the floats just below it
                moved = row.copy()
                moved[m] = c
                z64 = moved @ w0[:, j]
                if abs(z64) < 1e-9:
                    x = batch[0].clone()
                    x[entry, idx[0][entry] == n, m] = float(c)
                    z32 = chip_smoke.card_preactivations(
                        [params["w0"]], [params["b0"]], x, batch[3], CFG.dropout)[0]
                    if bool(z32[entry, r, j] > 0) != bool(z64 > 0):
                        X = X.copy()
                        X[entry, n, m] = c
                        return X, (r, j)
                c = np.nextafter(c, np.float32(-np.inf))
    raise AssertionError("no tie found")


def test_a_constructed_tie_is_flagged_and_passed():
    """G = 2.  One feature of a step-0 batch row set so that a kept layer-0
    pre-activation of entry 0 lies within 1e-9 of zero in FP64, with the
    other sign in FP32: the gate is flagged and takes FP32's sign, so the
    check passes, while FP64's own sign there puts the gradient over 1e-4."""
    X, y, idx, keeps, seeds = fed_data(5, 2)
    X, _ = plant_tie(X, y, idx, keeps, seeds)
    steps, _ = chip_smoke.check_fed_steps(CPU, X, y, idx, keeps, seeds, CFG)
    s0 = steps[0]
    assert s0["flagged"] >= 1 and s0["flipped"] >= 1, s0
    assert s0["grad_plain_max"] > 1e-4 and s0["grad"]["max"] < 1e-4, s0
    assert all(s["ok"] for s in steps), steps


class PlantedAdam(torch.optim.Optimizer):
    """Adam with L2 decay added to the gradient (torch.optim.Adam's update)
    in every grid entry but FAULTY, where the fault holds: AdamW's decoupled
    decay, or no bias correction."""

    def __init__(self, params, lr: float, weight_decay: float, fault: str):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay})
        self.fault = fault

    @torch.no_grad()
    def step(self):
        b1, b2, eps = 0.9, 0.999, chip_smoke.ADAM_EPS
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st.update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                              exp_avg_sq=torch.zeros_like(p))
                st["step"] += 1
                t = float(st["step"])
                one = torch.zeros((len(p),) + (1,) * (p.dim() - 1), dtype=torch.bool)
                one[FAULTY] = True
                decoupled = one & (self.fault == "decoupled_decay")
                g = torch.where(decoupled, p.grad, p.grad + wd * p)
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                plain = one & (self.fault == "no_bias_correction")
                bc1 = torch.where(plain, 1.0, 1 - b1 ** t)
                bc2 = torch.where(plain, 1.0, 1 - b2 ** t)
                p.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + eps)
                       + torch.where(decoupled, lr * wd * p, 0.0))


def plant(monkeypatch, fault: str) -> None:
    """Plant `fault` in grid entry FAULTY of every FP32 GridTrainer (the
    card's side; the FP64 reference run is left as it is)."""
    if fault in ("decoupled_decay", "no_bias_correction"):
        init = trainer.GridTrainer.__init__

        def planted_init(self, params, cfg, n_steps):
            init(self, params, cfg, n_steps)
            if self.weights[0].dtype == torch.float32:
                self.opt = PlantedAdam(self.weights + self.biases, cfg.learning_rate,
                                       cfg.weight_decay, fault)

        monkeypatch.setattr(trainer.GridTrainer, "__init__", planted_init)
    elif fault == "no_dropout_scale":
        apply = trainer.apply_mlp_grid

        def planted_apply(weights, biases, x, keeps=None, dropout=0.0):
            if x.dtype != torch.float32 or keeps is None:
                return apply(weights, biases, x, keeps, dropout)
            div = torch.full((len(x), 1, 1), 1.0 - dropout)
            div[FAULTY] = 1.0
            h = x
            for i, (w, b) in enumerate(zip(weights, biases)):
                h = torch.baddbmm(b.unsqueeze(1), h, w)
                if i < len(weights) - 1:
                    h = torch.where(keeps[i], torch.relu(h) / div, 0.0)
            return h

        monkeypatch.setattr(trainer, "apply_mlp_grid", planted_apply)
    else:
        losses = trainer.grid_losses

        def planted_losses(weights, biases, x, y, w, keeps, cfg):
            out = losses(weights, biases, x, y, w, keeps, cfg)
            if x.dtype != torch.float32:
                return out
            one = torch.arange(len(out)) == FAULTY
            if fault == "nan_grad":  # the same value, entry FAULTY's gradient NaN
                out = out + 0.0
                if out.requires_grad:
                    out.register_hook(lambda g: torch.where(one, float("nan"), g))
                return out
            if fault == "grad_scale":  # the same value, entry FAULTY's gradient x 1.001
                return out + torch.where(one, 1e-3, 0.0) * (out - out.detach())
            plain = losses(weights, biases, x, y, w, keeps,
                           dataclasses.replace(cfg, label_smoothing=0.0))
            return torch.where(one, plain, out)

        monkeypatch.setattr(trainer, "grid_losses", planted_losses)


# fault -> the parts of the new check it puts over their bounds (in entry
# FAULTY alone), and what the old chained check read on the same G = 3 run
# (the faulted FP32 chain against the clean one, per tensor, all entries
# stacked; bound 1e-4)
FAULTS = {
    "grad_scale": ({"grad"}, "missed: 5.9e-7"),
    "nan_grad": ({"grad", "update"}, "caught: NaN"),
    "decoupled_decay": ({"update"}, "caught: 1.1e-2"),
    "no_bias_correction": ({"update"}, "caught: 2.3"),
    "no_dropout_scale": ({"loss", "grad"}, "caught: 2.3e-1"),
    "no_smoothing": ({"loss", "grad"}, "caught: 4.6e-2"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_in_one_entry_fails_the_check(monkeypatch, fault):
    """G = 3, the fault in entry 1 alone: the check fails, and it names
    that entry and the parts the fault moves (FAULTS), at every step; the
    clean entries pass.  A NaN gradient also names the entry's values that
    are not finite (its gradients and new parameters).  A fault that moves a step by less than the bounds
    (the schedule's rate taken a few steps late, ~6e-5 near t = 0) is not
    planted."""
    parts, old = FAULTS[fault]
    data = fed_data(9, 3)
    clean, _ = chip_smoke.fed_steps(CPU, *data, CFG)
    plant(monkeypatch, fault)
    steps, _ = chip_smoke.check_fed_steps(CPU, *data, CFG)
    for s in steps:
        assert not s["ok"] and s["bitwise"]
        assert {p for p in chip_smoke.FED_BOUNDS if s["over"][p]} == parts, s
        assert all(s["over"][p] == [FAULTY] for p in parts), s
        assert s["over"]["finite"] == ([FAULTY] if fault == "nan_grad" else []), s
    faulted, _ = chip_smoke.fed_steps(CPU, *data, CFG)
    d = chained_distance(faulted, clean)
    assert (not d < 1e-4) == old.startswith("caught"), (fault, d)
