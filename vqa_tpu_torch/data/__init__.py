"""Data layer of the port: image decode, dataset, loader, device preprocess."""
