"""Kernel names of a device trace, and the port's kernels among them.

:func:`kernel_name` is a frozen copy of ``chip_smoke.py:kernel_name`` at
commit 030ba3ae819e6d9e24ff92eb0e364588e49180de (mangled names), extended
to the demangled C++ signatures a profiler reports.  Both give
``name<int and bool args[,position rule]>``, a bool as 0 or 1:
``selective_median_kernel<5,1>``, ``sweep_pc_kernel<1,PcRulePixel>``,
``paint_kernel<1,0>``.

The port's five kernels are three symbols: the pixel, the tile and the row
sweep all launch ``sweep_pc_kernel``; the row sweep under the position
rule ``PcRuleRow``, the pixel and the tile sweep under ``PcRulePixel``,
``PcRuleNearest`` and their ``Window`` twins.  The rule alone does not
tell the pixel sweep from the tile sweep: a metric that needs one of them
also reads the benchmark's span that launched the kernel.
"""

from __future__ import annotations

import re
from typing import Optional

#: the base names of the port's CUDA kernels (``csrc/``)
PORT_KERNELS = ("sweep_pc_kernel", "selective_median_kernel", "paint_kernel")


def _mangled_name(mangled: str) -> Optional[str]:
    m = re.search(r"\d([a-z_]+_kernel)((?:IL[ib]-?\d+E)?(?:L[ib]-?\d+E)*)",
                  mangled)
    if not m:
        return None
    args = re.findall(r"L[ib](-?\d+)E", m.group(2))
    # a type argument: its length, then its name (``11PcRulePixel``)
    rest = mangled[m.end():]
    args += [rest[t.start(2):t.start(2) + int(t.group(1))]
             for t in re.finditer(r"(\d+)(PcRule)", rest)]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def _demangled_name(sig: str) -> Optional[str]:
    sig = sig.replace("(anonymous namespace)::", "")
    m = re.search(r"([A-Za-z_]\w*_kernel)\s*(<[^()]*>)?\s*\(", sig)
    if not m:
        return None
    if not m.group(2):
        return m.group(1)
    args = []
    for a in m.group(2)[1:-1].split(","):
        a = a.strip().split("::")[-1].strip()
        args.append({"true": "1", "false": "0"}.get(a, a))
    return f"{m.group(1)}<{','.join(args)}>"


def kernel_name(name: str) -> Optional[str]:
    """``name<args>`` of a kernel's mangled or demangled name, None if no
    ``*_kernel`` is in it."""
    if name.startswith("_Z"):
        return _mangled_name(name)
    return _demangled_name(name)


def base_name(name: str) -> str:
    """The kernel's name without its template arguments; the name itself
    where it is no ``*_kernel`` (PyTorch's own kernels, copies)."""
    short = kernel_name(name)
    return name if short is None else short.split("<", 1)[0]


def is_port_kernel(name: str) -> bool:
    """One of the port's kernels (``csrc/``), by its base name."""
    return base_name(name) in PORT_KERNELS


def sweep_rule(name: str) -> Optional[str]:
    """The position rule a ``sweep_pc_kernel`` instantiation was built
    with (``PcRulePixel``, ``PcRuleRow``, ...), None for other kernels."""
    short = kernel_name(name)
    if short is None or not short.startswith("sweep_pc_kernel<"):
        return None
    rule = short[:-1].split(",")[-1]
    return rule if rule.startswith("PcRule") else None


def short_name(name: str) -> str:
    """A kernel's ``name<args>``, or its own name cut to 80 characters."""
    return kernel_name(name) or name[:80]
