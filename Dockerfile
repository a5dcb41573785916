# Reproducible environment for i3dr_stereo_tpu — the analog of the
# reference's Dockerfile (Dockerfile:1-35 there, melodic + pylon + Phobos
# pins) and install/*.rosinstall version pins.
#
# CPU image: tests + the 8-virtual-device mesh run as in CI. On an NVIDIA
# GPU host install JAX's CUDA plugin as well:
#   pip install "jax[cuda12]==0.9.0"

FROM python:3.12-slim

WORKDIR /opt/i3dr_stereo_tpu

# native toolchain for the optional C++ shm ring (native/shm_ring.cpp)
RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make && rm -rf /var/lib/apt/lists/*

COPY requirements.lock .
# exact pins from the validated environment (pip freeze)
RUN pip install --no-cache-dir -r requirements.lock

COPY . .
RUN pip install --no-cache-dir -e .

# CI entrypoint: full test suite on an 8-virtual-device CPU mesh
ENV JAX_PLATFORMS=cpu
CMD ["python", "-m", "pytest", "tests/", "-x", "-q"]
