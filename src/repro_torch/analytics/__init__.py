"""Data analytics on BaM: the NYC-taxi query suite."""
from repro_torch.analytics.taxi import (QUERIES, TaxiTable, make_taxi_table,
                                        oracle_value, run_query,
                                        run_query_baseline, scan_column,
                                        scan_column_runtime)

__all__ = ["TaxiTable", "make_taxi_table", "run_query",
           "run_query_baseline", "scan_column", "scan_column_runtime",
           "oracle_value", "QUERIES"]
