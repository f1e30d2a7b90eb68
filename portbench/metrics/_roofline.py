"""The GRU sequence kernels' share of their roofline: the least time of
the calls an iteration's update makes (counted from the configuration's
shapes, `flops.gru_calls` / `flops.gru_bounds`) over the device time of
the kernels whose function names (without return type, namespaces,
template arguments and parameters) start with the metric's prefixes."""
import json
from pathlib import Path

from portbench import flops


def function_name(kernel: str) -> str:
    """'void (anonymous namespace)::gru_fwd_wide_step<float>(float...)'
    -> 'gru_fwd_wide_step'."""
    depth, out = 0, []
    for ch in kernel.replace("(anonymous namespace)", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    words = "".join(out).split()
    return words[-1].split("::")[-1] if words else kernel


def share(ctx, data_file: str):
    data = json.loads(Path(data_file).read_text())
    tr = ctx["trace"]
    device_s = sum(e - s for n, s, e in tr["ops"]
                   if function_name(n).startswith(tuple(data["prefixes"]))
                   ) / 1e6
    if device_s <= 0:
        return None
    hp = {**ctx["config"]["model"], **ctx["config"]["ppo"]}
    calls, T, B, H = flops.gru_calls(hp, ctx["dims"])
    least_ms = flops.gru_bounds(T, B, H)[data["bound"]][0]
    return 100.0 * calls * tr["profiled"] * least_ms / 1e3 / device_s
