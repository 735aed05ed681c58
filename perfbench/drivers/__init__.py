"""One module per way of driving the program; a cell's workload file names
its driver."""
