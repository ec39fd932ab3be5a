"""The card's name and power limit from ``nvidia-smi``.

Copied from ``chip_smoke.py`` (``smi_id``, ``card_line``) at commit
794db71f23cf1f26fdc4edce6acfb7756f4932c5.
"""

from __future__ import annotations

import subprocess

import torch


def smi_id() -> str:
    """nvidia-smi's id of the card this process uses: its UUID."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return f"GPU-{props.uuid}"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", smi_id()],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
