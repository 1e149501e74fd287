"""Core modules of the port: ADC twin, QAT, trainer, genome, area, NSGA-II, co-design,
the pruned-ADC model frontend."""
