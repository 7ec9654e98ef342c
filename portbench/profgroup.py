"""Kernel groups of a ``torch.profiler`` run: a frozen copy of
``chip_smoke.py``'s ``_kernel_group`` with the tables it reads.

A kernel's profiler name is mapped to the wrapper of the program that
launches it (``tile_triangle<0, 1>`` is ``gram_matvec_symmetric``,
``gram_tier_symmetric`` is ``gram_matvec_symmetric_tier``); a name it does
not know is ``other``. The benchmark uses the groups to name the device
operations of its breakdown.
"""

import re

# The float64 tile's three forms (csrc/gram_comp.cu) and their finishing
# pass serve the wrappers of K1c, K3c, K7, K8 and the certified pairs, told
# apart by the form (the kernel's name; the finishing pass's last template
# argument, 0 triangle, 1 forward, 2 pair, absent in builds before the
# forward and pair forms), V's type ("d" in ptxas_report's keys, "double"
# in a demangled name) and the family (the forward form's first argument,
# LAPLACE_CODE: K3c).
COMP_FNS = ("gram_comp_symmetric", "gram_comp_forward", "gram_comp_pair", "gram_comp_finish")
COMP_FORMS = {"gram_comp_symmetric": 0, "gram_comp_forward": 1, "gram_comp_pair": 2}


def comp_wrapper(fn: str, args: str) -> str:
    """The wrapper of a float64-tile instantiation ``fn<args>`` (as in
    ``"0, 4, double"``)."""
    parts = [a.strip(" <>") for a in args.split(",")]
    if fn == "gram_comp_finish":
        vt, form = parts[0], int(parts[1]) if len(parts) > 1 else 0
    else:
        vt, form = parts[-1], COMP_FORMS[fn]
    f64 = vt in ("d", "double")
    if form == 0:
        return "gram_matvec_symmetric_f64" if f64 else "gram_matvec_symmetric_comp"
    if form == 2:
        return "gram_pair_f64" if f64 else "gram_pair_comp"
    if f64:
        return "gram_matmat_f64"
    laplace = fn != "gram_comp_finish" and parts[0] == str(LAPLACE_CODE)
    return "laplace_matmat_comp" if laplace else "gram_matmat_comp"


# The register tile's three forms and the 3xTF32 wide kernel serve the
# squared-distance wrappers (K1, K2, K4) and the Laplace ones (K3, K5, K6),
# told apart by the family, their first template argument (LAPLACE_CODE).
TILE_FORMS = {"tile_forward": ("gram_matmat", "laplace_matmat_narrow"),
              "tile_triangle": ("gram_matvec_symmetric", "laplace_matvec_symmetric"),
              "tile_pair": ("gram_pair", "laplace_pair"),
              "gram_wide_tf32": ("gram_matmat", "laplace_matmat")}


def tile_wrapper(fn: str, args: str) -> str:
    """The wrapper of a register-tile instantiation ``fn<args>``."""
    family = args.strip(" <>").split(",")[0].strip()
    return TILE_FORMS[fn][family == str(LAPLACE_CODE)]


# The narrow kernel of builds before the float64 tile's forward form
# (gram_matmat_narrow<KIND, KC, MODE>, in old profiles): the family first
# (LAPLACE is 4), the Mode last (COMP 1, F64 2).
_NARROW = {1: "gram_matmat_comp", 2: "gram_matmat_f64"}
_LAPLACE = {"gram_matmat_comp": "laplace_matmat_comp"}
LAPLACE_CODE = 4


# Kernels of their own, by name (their template arguments do not select the
# group): K2b, K1b's forward strip and wide kernel, K4b; the float64 tile's
# by form, family and V's type (comp_wrapper).
_OWN = {"gram_tier_symmetric": "gram_matvec_symmetric_tier",
        "gram_tier_forward": "gram_matmat_tier", "gram_tier_wide": "gram_matmat_tier",
        "gram_tier_pair": "gram_pair_tier"}
# Kernels whose names hold no gram_ prefix: the probes, and K3's tile in its
# two forms as earlier builds named them (K3, K5); the register tile's forms
# and the wide kernel by family (TILE_FORMS).
_OWN_NAMED = {"laplace_forward": "laplace_matmat_narrow",
              "laplace_triangle": "laplace_matvec_symmetric", "probe_l1": "probe_l1",
              "probe_chain": "probe_chain"}


def _kernel_group(name: str) -> str:
    if "sum_splits" in name:
        return "sum_splits"
    if "csr_spmm" in name:
        return "csr_spmm"
    m = re.search(r"(tile_forward|tile_triangle|tile_pair|gram_wide_tf32)<([^>]*)>", name)
    if m:
        return tile_wrapper(m.group(1), m.group(2))
    for own, group in _OWN_NAMED.items():
        if own in name:
            return group
    m = re.search(r"(gram_\w+)(?:<([^>]*)>)?", name)
    if m is None:
        return "other"
    if m.group(1) in COMP_FNS:
        return comp_wrapper(m.group(1), m.group(2) or "")
    if m.group(1) in _OWN:
        return _OWN[m.group(1)]
    if m.group(2) is None:
        return "other"
    args = [a.strip() for a in m.group(2).split(",")]
    # gram_matmat_narrow<KIND, KC, MODE> ends in MODE
    try:
        family = int(args[0])
        group = _NARROW.get(int(args[-1]), "other")
    except (ValueError, IndexError):
        return "other"
    return _LAPLACE.get(group, group) if family == LAPLACE_CODE else group
