"""The port's models: the flagship Llama decoder (model, weight
conversion, generation, serving, training) and the reference's benchmark
families (ResNet-V2, VGG-16, DeepLab-v3, the LSTM) with bench.py's cases
in models/workloads.py."""
