from gps_sdr_sim_tpu_torch.utils.cstd import c_round, c_atof, c_atoi  # noqa: F401
