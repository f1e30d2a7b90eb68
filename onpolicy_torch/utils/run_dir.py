"""Run-directory layout + metrics logging.

The port's own copy of `onpolicy_tpu/utils/run_dir.py`: the reference's
results layout (results/<env>/<scenario>/<algo>/<exp>/run<k>) and its
tensorboard/wandb dual sink, with a plain JSONL sink always on
(wandb/tensorboardX optional, import-gated). The results root is
`$ONPOLICY_TORCH_RESULTS`, else `results/` under the working directory.
"""
from __future__ import annotations

import json
import os
from pathlib import Path


def make_run_dir(cfg) -> Path:
    base = Path(os.environ.get("ONPOLICY_TORCH_RESULTS", "results"))
    d = base / cfg.env_name / cfg.scenario_name / cfg.algorithm_name / \
        cfg.experiment_name
    d.mkdir(parents=True, exist_ok=True)
    runs = [p for p in d.glob("run*") if p.is_dir()]
    idx = 1 + max([int(p.name[3:]) for p in runs if p.name[3:].isdigit()],
                  default=0)
    run_dir = d / f"run{idx}"
    run_dir.mkdir()
    return run_dir


class MetricsLogger:
    """Callable log sink: prints, appends JSONL, and forwards to
    wandb/tensorboardX when available + enabled."""

    def __init__(self, run_dir: Path, cfg):
        self.run_dir = Path(run_dir)
        self.jsonl = open(self.run_dir / "metrics.jsonl", "a")
        (self.run_dir / "config.json").write_text(
            json.dumps({k: str(v) for k, v in vars(cfg).items()}, indent=2))
        self.wandb = None
        self.tb = None
        if getattr(cfg, "use_wandb", False):
            try:
                import wandb
                # a sweep agent may have initialized the run already
                # (apply_wandb_sweep) — reuse it instead of re-init
                self.wandb = getattr(wandb, "run", None) or wandb.init(
                    project=cfg.env_name, name=f"{cfg.algorithm_name}_"
                    f"{cfg.experiment_name}_seed{cfg.seed}",
                    dir=str(self.run_dir), config=vars(cfg))
            except Exception:
                pass
        else:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(str(self.run_dir / "logs"))
            except Exception:
                pass

    def __call__(self, row):
        if isinstance(row, str):
            print(row)
            return
        print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in row.items()))
        self.jsonl.write(json.dumps(row) + "\n")
        self.jsonl.flush()
        step = row.get("steps", 0)
        if self.wandb is not None:
            self.wandb.log(row, step=step)
        if self.tb is not None:
            for k, v in row.items():
                if isinstance(v, (int, float)) and k != "steps":
                    self.tb.add_scalar(k, v, step)

    def close(self):
        self.jsonl.close()
        if self.wandb is not None:
            self.wandb.finish()
        if self.tb is not None:
            self.tb.close()
