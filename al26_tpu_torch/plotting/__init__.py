"""Analysis and figures (the port's counterpart of al26_tpu.plotting):
file readers, snapshot diagnostics on torch tensors, the ensemble
post-processor and the figure scripts. Importing it imports neither
matplotlib nor pandas."""
from . import lib
from .lib import (
    calc_cdf,
    calc_cluster_half_mass,
    calc_current_heating_rate,
    calc_dE,
    calc_disk_final_enrichment,
    calc_etot,
    calc_global_model_yield,
    calc_local_densities,
    calc_sn_times,
    get_high_mass_star_indices,
    read_interloper_trajectory,
    read_state,
    read_yields,
)
