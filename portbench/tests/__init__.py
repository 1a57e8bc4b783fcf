"""Tests of the benchmark harness (not collected by the repository's tier-1 run)."""
