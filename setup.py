from setuptools import find_packages, setup

setup(
    name="kspider-tpu",
    version="0.1.0",
    description="TPU-native sequence clustering engine (kSpider capabilities)",
    packages=find_packages(
        include=["kspider_tpu", "kspider_tpu.*",
                 "kspider_tpu_torch", "kspider_tpu_torch.*"]
    ),
    package_data={"kspider_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.9",
    install_requires=[
        "click",
        "numpy",
        "jax",
        "pandas",
        "scipy",
        "torch",
        "tqdm",
    ],
    entry_points={
        "console_scripts": [
            "kspider=kspider_tpu.cli.main:main",
            "kspider-torch=kspider_tpu_torch.cli.main:main",
        ]
    },
)
