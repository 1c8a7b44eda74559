"""The benchmark evaluation: reconstruction metrics and the test loop."""
