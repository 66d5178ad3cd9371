"""The benchmark of the PyTorch and CUDA port (`repro_torch`): YCSB cells
of the F2 store on one H100.  `python3 f2bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` from the repository root; cells,
configurations, traffic mixes and metrics are found by name (see
`manifest`)."""
