"""Assigned architecture configs (exact figures from the assignment table)
plus reduced smoke configs and the paper's own benchmark config."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "kimi-k2-1t-a32b",
    "qwen2-moe-a2.7b",
    "xlstm-125m",
    "chatglm3-6b",
    "phi4-mini-3.8b",
    "mistral-nemo-12b",
    "gemma3-4b",
    "qwen2-vl-72b",
    "whisper-large-v3",
    "recurrentgemma-9b",
]


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, smoke: bool = False):
    m = _module(arch_id)
    return m.SMOKE_CONFIG if smoke else m.CONFIG


def list_archs():
    return list(ARCH_IDS)


# ---- input-shape cells (assignment: LM shapes seq_len x global_batch) -----
SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4096,    global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768,   global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32768,   global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524288,  global_batch=1),
}

# long_500k needs sub-quadratic attention: run for SSM/hybrid/local-window
# archs, skip for pure full-attention archs (DESIGN.md §6)
LONG_OK = {"xlstm-125m", "recurrentgemma-9b", "gemma3-4b"}


def shape_applicable(arch_id: str, shape_id: str) -> bool:
    if shape_id == "long_500k":
        return arch_id in LONG_OK
    return True


def cells():
    """All applicable (arch, shape) dry-run cells."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            if shape_applicable(a, s):
                out.append((a, s))
    return out