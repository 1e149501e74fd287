"""Core modules of the port: ADC twin, QAT, trainer, genome, area, NSGA-II with its
island drivers, co-design, campaign, memo store, the pruned-ADC model frontend."""
