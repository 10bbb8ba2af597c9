"""Classifier parameters and epilogue as float64 torch (the port of
meshclust2_tpu/model/classifier.py)."""
