"""The paper's benchmark networks, built with the port's ModelSpec."""
