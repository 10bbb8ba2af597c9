"""The benchmark's harness: plan, pools, jobs, trace, check, result."""
