"""Astaroth configuration: key = value file parser with derived parameters
and an uninitialized-value check.

The port's own copy of ``stencil_tpu.astaroth.config`` (pure Python), a
re-implementation of the reference's config machinery
(reference: astaroth/astaroth_utils.cu:23-123 — ``parse_config``,
``acHostUpdateBuiltinParams`` derived params, and ``acLoadConfig``'s
0xFF-poison uninitialized detection; astaroth/astaroth.conf). Instead of
poisoning raw struct bytes, every known parameter starts as ``None`` and
``load_config`` reports which stayed unset.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

STENCIL_ORDER = 6  # reference: astaroth/astaroth.h:9

# Parameters read from astaroth.conf (reference: user_defines.h int/real
# param tables). Anything not listed is ignored with a warning, like
# find_str returning -1 in the reference parser.
INT_PARAMS = (
    "AC_nx", "AC_ny", "AC_nz",
    "AC_max_steps", "AC_save_steps", "AC_bin_steps", "AC_start_step",
    "AC_bc_type_top_x", "AC_bc_type_top_y", "AC_bc_type_top_z",
    "AC_bc_type_bot_x", "AC_bc_type_bot_y", "AC_bc_type_bot_z",
)
REAL_PARAMS = (
    "AC_dsx", "AC_dsy", "AC_dsz",
    "AC_dt", "AC_max_time", "AC_cdt", "AC_cdtv", "AC_cdts",
    "AC_nu_visc", "AC_cs_sound", "AC_zeta", "AC_eta", "AC_mu0", "AC_chi",
    "AC_relhel", "AC_forcing_magnitude", "AC_kmin", "AC_kmax",
    "AC_switch_accretion",
    "AC_cp_sound", "AC_gamma", "AC_lnT0", "AC_lnrho0",
    "AC_sink_pos_x", "AC_sink_pos_y", "AC_sink_pos_z",
    "AC_M_sink_Msun", "AC_soft", "AC_accretion_range",
    "AC_unit_velocity", "AC_unit_density", "AC_unit_length",
    "AC_ampl_lnrho", "AC_ampl_uu", "AC_bin_save_t",
)


@dataclass
class AcMeshInfo:
    """Parameter set with the reference's derived-parameter rules."""

    int_params: Dict[str, Optional[int]] = field(
        default_factory=lambda: {k: None for k in INT_PARAMS}
    )
    real_params: Dict[str, Optional[float]] = field(
        default_factory=lambda: {k: None for k in REAL_PARAMS}
    )

    def __getitem__(self, key: str):
        if key in self.int_params:
            return self.int_params[key]
        if key in self.real_params:
            return self.real_params[key]
        raise KeyError(key)

    def __setitem__(self, key: str, value) -> None:
        if key in self.int_params:
            self.int_params[key] = int(value)
        elif key in self.real_params:
            self.real_params[key] = float(value)
        else:
            raise KeyError(key)

    # derived params (reference: astaroth_utils.cu:52-88)
    def update_builtin_params(self) -> None:
        ip, rp = self.int_params, self.real_params
        if any(ip.get(k) is None for k in ("AC_nx", "AC_ny", "AC_nz")):
            return  # leave missing extents for the poison report
        ip["AC_mx"] = ip["AC_nx"] + STENCIL_ORDER
        ip["AC_my"] = ip["AC_ny"] + STENCIL_ORDER
        ip["AC_mz"] = ip["AC_nz"] + STENCIL_ORDER
        ip["AC_nx_min"] = STENCIL_ORDER // 2
        ip["AC_nx_max"] = ip["AC_nx_min"] + ip["AC_nx"]
        ip["AC_ny_min"] = STENCIL_ORDER // 2
        ip["AC_ny_max"] = ip["AC_ny"] + STENCIL_ORDER // 2
        ip["AC_nz_min"] = STENCIL_ORDER // 2
        ip["AC_nz_max"] = ip["AC_nz"] + STENCIL_ORDER // 2
        for a in ("x", "y", "z"):
            if rp.get(f"AC_ds{a}") is not None:
                rp[f"AC_inv_ds{a}"] = 1.0 / rp[f"AC_ds{a}"]
        ip["AC_mxy"] = ip["AC_mx"] * ip["AC_my"]
        ip["AC_nxy"] = ip["AC_nx"] * ip["AC_ny"]
        ip["AC_nxyz"] = ip["AC_nxy"] * ip["AC_nz"]
        # cs2 (reference: user_kernels.h AC_cs2_sound = cs^2)
        if rp.get("AC_cs_sound") is not None:
            rp["AC_cs2_sound"] = rp["AC_cs_sound"] ** 2

    def uninitialized(self) -> List[str]:
        """Names of parameters never set (the poison check,
        astaroth_utils.cu:100-120)."""
        missing = [k for k, v in self.int_params.items() if v is None]
        missing += [k for k, v in self.real_params.items() if v is None]
        return missing


_LINE_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*=\s*([^\s/]+)")


def parse_config(text: str, info: AcMeshInfo) -> None:
    """Parse ``key = value`` lines; ``//`` and ``/* */`` comments ignored
    (reference: astaroth_utils.cu:23-48)."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    for line in text.splitlines():
        line = line.split("//")[0]
        m = _LINE_RE.match(line)
        if not m:
            continue
        key, value = m.group(1), m.group(2)
        if key in info.int_params:
            info.int_params[key] = int(float(value))
        elif key in info.real_params:
            info.real_params[key] = float(value)
        # unknown keys ignored, like the reference's find_str miss


def load_config(path: str) -> Tuple[AcMeshInfo, bool]:
    """Returns (info, ok). ``ok`` is False if any parameter stayed unset
    (the reference's AC_FAILURE poison result)."""
    info = AcMeshInfo()
    with open(path) as f:
        parse_config(f.read(), info)
    info.update_builtin_params()
    return info, not info.uninitialized()
