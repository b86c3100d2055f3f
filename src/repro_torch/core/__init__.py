"""Core of the RANGE-LSH port: hashing, partitioning, probing, the bucket
store, the query engines and the recall-contract planner."""
