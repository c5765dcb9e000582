"""The harness: finds a cell's files by name (`bench`), builds the system
under test (`system`), drives its traffic (`session`, `traffic`), reads a
profiler trace (`trace`), reduces records to metrics (`stats`,
`yardstick`, the readers under `benchmark/metrics/`) and decides `correct`
(`check`)."""
