"""Datasets (ade20k, flickr) and the batch loader."""
