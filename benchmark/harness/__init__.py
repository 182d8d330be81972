"""The benchmark's harness: the cell's inputs (`traffic`), the system under
test (`program`), the timed window and the run's result (`main`), the
traced stretch (`trace`), the work the roofline counts (`work`) and the
comparison that decides `correct` (`compare`)."""
