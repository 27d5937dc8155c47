"""Data layer of the port: device-side image preprocess."""
