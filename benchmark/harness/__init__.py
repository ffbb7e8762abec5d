"""The port's benchmark harness: one cell of BENCHMARK.json run once
(`cell.run_cell`), driven by data found by name (`manifest`): a
configuration's sizes in configs/<config>.json and its builder in
builders/<builder>.py, a traffic mix's parameters in traffic/<mix>.json
and its loop in drivers/<driver>.py, a metric's reader in
metrics/<metric>.py. The program under test is `rsvldm_tpu_torch`; the
yardstick (traffic, weights, counting, trace reduction, the reference and
the comparison) lives here and in benchmark/reference/."""
