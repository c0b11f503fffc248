#!/bin/bash
# Launch a multi-host render over GPU hosts (replaces the reference's
# rsync+ssh deploy.sh with the JAX multi-controller runtime). One process
# per host drives every GPU of that host.
#
# Usage: COORD=host0:8476 NPROC=2 script/launch_pod.sh scenes/cornell.pbrt
# Run once per host with PROCESS_ID set (or let your scheduler set it).
set -eu
scene="$1"; shift
: "${COORD:?set COORD=host:port}"
: "${NPROC:?set NPROC=num hosts}"
: "${PROCESS_ID:=0}"
exec python -m curry_pbrt_tpu.parallel.multihost "$scene" \
  --coordinator="$COORD" --num-processes="$NPROC" --process-id="$PROCESS_ID" "$@"
