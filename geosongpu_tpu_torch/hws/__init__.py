"""The hardware sampler: power, energy, utilization and memory of the card
(through NVML) and of the host, sampled beside a run and integrated."""
