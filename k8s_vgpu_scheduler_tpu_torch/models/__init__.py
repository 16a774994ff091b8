"""Flagship Llama decoder: model, weight conversion, generation, serving."""
