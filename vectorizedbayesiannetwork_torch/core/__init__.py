"""Core abstractions: queries, CPD contract, DAG, plans, random streams."""
