"""Core PIM math (plans, programming, exact arithmetic) and the Table-II
workload descriptors."""
