from setuptools import find_packages, setup

setup(
    name="ribodetector_tpu",
    version="0.1.0",
    description="TPU-native rRNA read-classification engine (JAX/XLA/Pallas)",
    packages=find_packages(
        include=[
            "ribodetector_tpu", "ribodetector_tpu.*",
            "ribodetector_tpu_torch", "ribodetector_tpu_torch.*",
        ]
    ),
    # native/fastx.cpp MUST ship: the C parser builds on first use from
    # source (no Python headers needed); without it installed copies would
    # silently fall back to the slow portable path
    package_data={
        "ribodetector_tpu": ["data/*.npz", "config.json", "native/fastx.cpp"],
        # the PyTorch/CUDA port builds its kernels (nvcc) and parser (g++)
        # from these sources at first use
        "ribodetector_tpu_torch": [
            "data/*.npz", "config.json", "native/fastx.cpp", "csrc/*.cu",
        ],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={"convert": ["torch"], "train": ["optax"], "cuda": ["torch"]},
    entry_points={
        "console_scripts": [
            # reference command names (reference: setup.py:42-45) plus the
            # native name; one engine backs all three
            "ribodetector=ribodetector_tpu.cli:main",
            "ribodetector_cpu=ribodetector_tpu.cli:main_cpu",
            "ribodetector_tpu=ribodetector_tpu.cli:main",
            "ribodetector_tpu_serve=ribodetector_tpu.serve:main",
            # the PyTorch/CUDA port: on the card, or pinned to the CPU
            "ribodetector_tpu_torch=ribodetector_tpu_torch.cli:main",
            "ribodetector_tpu_torch_cpu=ribodetector_tpu_torch.cli:main_cpu",
            "ribodetector_tpu_torch_serve=ribodetector_tpu_torch.serve:main",
        ]
    },
)
