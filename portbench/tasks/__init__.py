"""One module a kind of training the benchmark drives, named by a
configuration's ``task``. Each defines ``Program(config, workload, seed,
device, cache_root)``: the program under test built from the configuration
and the workload, with the calls the harness makes (see
:mod:`portbench.harness`)."""
