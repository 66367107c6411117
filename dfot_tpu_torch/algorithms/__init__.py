"""Algorithm-level sampling glue and the flagship recipe."""
