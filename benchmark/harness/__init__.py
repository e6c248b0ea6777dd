"""The general code of the benchmark: it reads cells, configurations,
traffic mixes, limits and metric readers as data and never names one."""
