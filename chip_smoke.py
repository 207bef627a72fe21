"""Drive the PyTorch/CUDA port on one GPU and hold every kernel against its
plain PyTorch version.

  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:

1. build   -- compile csrc/*.cu with nvcc for sm_90a (one nvcc per source,
              in parallel); print the build seconds and ptxas's register /
              shared-memory report, the persistent chunk's on-chip passes
              (held to persistent_stencil.chunk_passes for k = 1..12), its
              dynamic shared memory and resident blocks per SM; each
              multistep instantiation's registers, spill bytes and blocks
              per SM, fp32 and fp64, its threads and shared memory held to
              the wrapper's (stencil_kernels.multistep_shape), no spill at
              the planner's depth in fp32 and at any depth in fp64, the
              fp32 k=3 build at 80 registers and one 736-thread block per
              SM; the fused step kernel's registers, spill bytes and
              blocks per SM (no spill, at least 2 blocks), its launch shape
              held to fused_stencil.fused_shape and its z-chunk rule to
              fused_stencil.fused_zchunks at five shapes; the registers and
              spill of each wire instantiation of the fused step (bf16,
              fp16, fp8 e4m3, fp8 e5m2 and SOFT, the software formats) and
              of the exchange carriers' row-move body (fp32 words
              unnarrowed and through bf16, fp16, e4m3, e5m2 and SOFT; fp64
              words also through fp32), none spilling, the unnarrowed body
              held to 32 registers for both words;
              the sweep kernel's (B1, the same body's flex_tile over a task
              table) registers, spill bytes and blocks per SM in fp32 and
              fp64, its launch shape held to stencil_kernels' (no spill, 2
              blocks of 352 threads; the fused step keeps 3); B1's fp32
              build held to 72 registers and B8's to 56 (the fp64 templates
              leave them as they were).
2. kernels -- each kernel against its plain version on the card with
              torch.equal, at several shapes (aligned, unaligned, tight-x,
              odd sizes, non-wrapping axes, fp32 and fp64 fills; the sweep
              at 512^3 r1 and tight-x all-wrap, 100x70x50 unaligned,
              256x64x40 tight-x, 33x21x13 r2 with z and x halos read,
              67x45x29 and 130x70x40, each with random sel codes read on
              every plane and on 6 planes, and the spheres on their planes;
              the
              multistep at every k = 1..6 on 67x45x29 and 130x70x40 (ragged
              against its tile) with one and several z chunks and on the
              32^3 tenant size, tight-x at k = 2, 3, 5, 512^3 at the
              planner's depth; for the
              fill also 67x33x21 unaligned with asymmetric radii at nq 1 and
              16, the same one word off alignment, r2, r4 and r5, and a
              z-stack of three fp64 blocks, so that its scalar, 8- and
              16-byte paths all run; a vector width that does not divide
              the layout is refused), and each timed at the main path's
              shape beside its plain version and its bound; the fill per
              axis (apps/bench_fill.py) at 512^3 r3 x4 fp32, its (1,1,2)
              z-stack form and Astaroth's 256^3 r3 x8 fp64, with the halos
              partly in L2 and evicted, beside its bytes bound, its 32-byte
              sector floor and the Tensor.copy_ yardstick.
3. jacobi3d -- the main path: apps.jacobi3d.run at 512^3 fp32 in chunks
              of 25 (25 // k multistep passes and 25 % k sweeps each), launch
              counts set to 0 just before and read just after and held to
              those numbers; then 2k+2 steps at 512^3
              through the kernels against the same steps through the plain
              versions (bit-equal), and a small run against the float64
              numpy reference.
4. exchange -- DistributedDomain.exchange_loop at 512^3, radius 3, four fp32
              quantities, launch counts reset around it; bit-equal to the
              plain fill; GB/s beside the Tensor.copy_ yardstick.
5. astaroth -- each substep instantiation's registers, spill bytes and
              blocks per SM, its launch shape held to the wrapper's; the
              RK3 substep kernel against its plain version (stages 0-2,
              fp32 and fp64, at 64^3, 40x24x20, ragged 33x13x7 and
              200x100x61 and 48x40x36 at radius 4, random fields, dt 0.1;
              torch.equal); the
              same at 256^3 in fp64 and fp32, where each block marches
              the whole z extent: one iteration from the app's init at its dt,
              and random fields at dt 0.1; apps.astaroth.run at the
              conf's 256^3 in fp64 and fp32 with launch counts reset around
              each (3 substeps and one exchange per iteration); a small run
              on the card against the same run on the CPU; the kernel timed
              per launch at 256^3 beside its plain version, its bound and
              its unfused issue floor.
6. remote-dma -- jacobi3d's remote-dma kernel variants: the fused step kernel
              against its plain version (torch.equal on curr with its halos
              and on out) at 512^3 r1, 100x70x50 unaligned r1 and 33x21x13
              r2, and with sel codes in [-1, 4) at 200x100x61 and 513x37x19
              r1 unaligned (a row pitch whose 16-byte phase moves every
              row, ragged last tiles) and 70x45x29 r3 aligned and
              unaligned, and the persistent chunk kernel (torch.equal on both
              buffers) at 200x100x60 k=2,3,4,6 and k=8 (two on-chip
              passes, the result in curr), 16x16x14 k=2, 16x16x13 k=4,
              33x21x13 k=3 (ragged tiles and z chunks) and 512^3 k=4, all
              from random fields and random sel (codes in [-1, 4) at
              200x100x60 k=4, 33x21x13 and k=8); the
              main paths from the app's init, launch counts reset around
              each: apps.jacobi3d.run at 512^3 with kernel_variant fused
              (50 iters, chunks of 25: 75 fused launches, no other kernel)
              and persistent with deep_halo 4 (48 iters, chunks of 24: 18
              chunk launches, 9 fills of sel), and the plain remote-dma
              method (15 steps); 8 steps at 512^3 from a random field
              through the fused and the persistent (k=4) loops, bit-equal on
              the compute region to the default multistep path; each kernel
              timed per launch at 512^3 beside its plain version and bound.
7. resident -- multi-block partitions with every block on the card: the
              deep-halo multistep against its plain version (torch.equal,
              from random fields with noise in every halo) on (2,2,2) 512^3
              r4 at k = 2..4 (spheres crossing block edges), 100x70x60
              unaligned, (1,1,2) mixed wrap, and the (1,1,2) 128x16x20 case
              whose spheres cross the periodic z edge; the stacked sweep and
              every shell of every block in one launch (sweep_regions; and
              sweep_region on one shell), random sel and the spheres on each
              block's planes, the z-stack fill (x, y; fp32 and
              fp64) and the resident exchange (config 2, (1,1,2) and
              (2,1,1), on the card against the same exchange on the CPU,
              every cell, with its fill launches counted), all equal; 8
              steps on (2,2,2) and (1,1,2) from a random field, bit-equal
              on the gathered compute region to the single-block default
              path; the main paths apps.jacobi3d.run at 512^3 (2,2,2) with
              deep_halo 4 and 1 (50 iters, chunks of 25 each), launch
              counts reset around each; the config-2 exchange (256^3,
              (2,2,2), r2, x4), 512^3 (1,1,2) r3 x4 and the deep_halo=4
              run's own exchange (512^3 (2,2,2) r4, one quantity) in GB/s;
              the new forms timed beside their plain versions and bounds
              (the z-stack fill's times are phase 2's).
8. campaign -- the multi-tenant path: the tenant-form sweep (B tenants of a
              (B, pz, py, px) stack, every axis wrapping onto its tenant, one
              launch) against its plain version (torch.equal, random fields and
              sel) at B=64 of 32^3, B=3 of 33x21x13 r1 and r2, B=1 of 32^3 and
              B=70,000 of 4^3 (over the 65,535 limit of grid.y/z); a float64
              slot on the card against the same slot on the CPU;
              make_batched_jacobi_loop on the card
              against the CPU (B=8 of 24^3, 3 steps, compute regions; random
              sel on the spheres' planes and on every plane, the CPU's then
              zeroed off those planes, which the card does not read); the
              campaign CLI's A/B (apps.campaign.run_modes --mode ab
              --check-parity, 6 steps in chunks of 3) at 64 tenants of 32^3 and
              of 128^3, launch counts reset around each (6 tenant sweeps; 128
              multistep passes, no sweeps), with Mcells/s and p50/p99 step
              latency, then 30 batched steps of the same slot, whose median
              chunk gives its device work (3 tenant sweeps and the per-lane
              health reductions) against its wall time (the host's share);
              the fault run (8 tenants, slot 4,
              nan@3 on t1 every time: t1 evicted with rc-43 evidence, the
              survivors byte-equal to a clean run, --resume revives t1
              byte-equal); the tenant sweep at B=64 of 128^3 against its plain
              version (torch.equal), with the campaign's own call (the
              spheres on their planes) at 64 of 32^3 and of 128^3 too, then
              timed per launch.
9. mesh -- eight block positions on the one card (DeviceMesh with the card
              named 8 times, one block per position, each its own
              allocation): the axis carrier remote_axis (every ring phase)
              and the fused exchange carrier fused_exchange against their
              plain versions (torch.equal on every cell of every position,
              random fields with noise in every halo) at config 2 (256^3
              (2,2,2) r2 x4), 512^3 (2,2,2) r1, 100x70x60 (1,1,2) r1,
              66x20x16 (2,1,1) r2 with two fp64 quantities, a 64^3
              fp32 + fp64 + fp32 dict, 100x70x60 (2,2,2) r1 unaligned
              (odd pitches: one word a lane), 96x64x48 (2,2,2) with face
              radii x 0/2, y 1/2, z 2/1 in fp32 and fp64 and 70x34x26
              (2,2,1) unaligned fp64 with x 1/3, y 0/1, z 1/2 (a lone x
              message, rm == 0), and 128^3 (2,2,2) r2 with two fp64
              quantities, and both mesh exchanges on the card against the
              CPU; the mesh exchange gathered into the stacked
              layout against the resident axis-composed exchange at config 2
              and 512^3 r1; 8 steps at 512^3 over 8 positions from a random
              field, bit-equal to the single-block default path; the main
              path apps.jacobi3d.run at 512^3 with devices=[cuda:0]*8 and
              method REMOTE_DMA (50 iters, chunks of 25: 225 remote_axis and
              75 sweep launches, one a step for the 8 positions, no other
              kernel), launch counts reset
              around it; DistributedDomain.exchange_loop at config 2 through
              each carrier in GB/s beside the resident config-2 number of
              phase 7 and the Tensor.copy_ yardstick, and the B6 exchange's
              time against its three launches' device time (the rest is
              the host's); each kernel timed per launch beside its plain
              version, its bytes bound, its sector floor and Tensor.copy_
              (remote_axis per phase at config 2 and at 512^3 (2,2,2) r1,
              fused_exchange at both);
              the sweep of the 8 positions of 256^3 in one launch (no wrap)
              against its plain version, each position's spheres on its own
              planes and random sel, timed per launch, and one position
              alone;
              then the narrowed wire (mesh_wire_phase): remote_axis and
              fused_exchange with a wire against their plain versions by bit
              pattern on every cell of every position (NaN as one pattern)
              at config 2 and 512^3 (2,2,2) r1 through bf16 and fp8, 128^3
              (2,2,2) r2 x2 and 66x20x16 (2,1,1) r2 x2 fp64 through fp32 and
              bf16, a 64^3 fp32 + fp64 + int32 dict, and fields of edge
              values (fp8's overflow and subnormals, inf, NaN) through every
              pair; each case's whole mesh exchange, plain and fused, on
              the card against the CPU; 8 steps at 512^3 over 8 positions
              with bf16 and with fp8 on the wire against the same loop on
              the CPU; the main path apps.jacobi3d.run(512, 512, 512,
              devices=[cuda:0]*8, method REMOTE_DMA, wire_dtype="bfloat16")
              (225 remote_axis launches, all narrowed, and 75 sweeps of the
              8 positions) beside
              the unnarrowed run in turns; B6 per phase at config 2 and
              512^3 r1 and B7 at config 2 timed per launch unnarrowed, bf16,
              fp8, fp8, bf16, unnarrowed, beside the bytes bound and sector
              floor; exchange_loop at config 2 through each carrier with
              and without a wire; 8 steps with fp8 e5m2 on the wire too;
              then every other format the JAX package narrows through
              (mesh_formats_phase; e5m2, e4m3fnuz, e5m2fnuz, e4m3b11fnuz,
              e3m4, e4m3, e8m0fnu, fp4 e2m1fn): B6 per ring phase and B7
              against their plain versions by bit pattern on fields of each
              format's edge values (its largest value, overflow tie, least
              normal and subnormals, +-0, +-inf, NaN) at 32^3 (2,2,2) r2
              fp32 and 40x36x20 (1,2,2) r1 fp64 and on a 64^3 fp32 + fp64
              + int32 dict, each mesh exchange on the card against the CPU;
              the wire on an oversubscribed mesh ((4,2,2) blocks of 256^3 on
              (2,2,2) positions, fp32 through bf16 and e3m4, fp64 through
              fp32 and e5m2; (2,2,2) blocks of 128^3 on (1,2,2), x's
              residents bit copies) against its plain version with its
              narrowed launches held; one Astaroth step and one fused-loop
              iteration over (2,2,2) x 128^3 fp64 through an fp32 wire
              against the same run with the carriers' plain versions; B6
              per phase, B7 and the oversubscribed exchange at config 2
              timed unnarrowed, e5m2, e4m3 (a software format), e4m3,
              e5m2, unnarrowed; jacobi3d 512^3 over 8 positions through
              e5m2 and through e4m3, and over (4,2,2) blocks on them through
              e5m2, launch counts held.
10. mesh variants -- the wire-crossing forms of the fused step and the
              persistent chunk, one cooperative launch over every position
              of the mesh: fused_jacobi_mesh against its plain version
              (torch.equal on every cell of every position, curr with its
              halos and nxt) at 512^3 (2,2,2) r1, 100x70x60 (1,1,2) r1 and
              24x20x16 (2,1,1) r1 (ragged tiles, sel codes in [-1, 4)),
              persistent_jacobi_mesh (both buffers and sel) at 200x100x60
              (2,2,2) k=2,3,4 and k=8, 16x16x14 (2,1,1) k=2, 66x42x26
              (2,2,2) k=3 (33x21x13 blocks: ragged tiles and z chunks) and
              512^3 (2,2,2) k=4, from random fields, random sel (codes in
              [-1, 4) at k=8 and 66x42x26) and noise in every halo; 8
              steps at 512^3 over 8 positions from phase 9's random field
              through the fused loop and the persistent loop (k=4), each
              bit-equal on the compute region to the single-block default
              path and to the plain mesh loop; the main paths
              apps.jacobi3d.run at 512^3 with devices=[cuda:0]*8, method
              REMOTE_DMA and kernel_variant fused (50 iters, chunks of 25:
              75 fused_jacobi_mesh launches, no other kernel) and
              persistent with deep_halo 4 (48 iters, chunks of 24: 18
              chunk launches and 9 remote_axis launches, sel's exchange once
              per loop call), launch counts reset around each; each kernel
              timed per launch at 512^3 beside its plain version and bound;
              then the narrowed wire (variant_wire_phase): fused_jacobi_mesh
              with a wire against its plain version by bit pattern at 512^3
              (2,2,2) r1 (bf16, fp8) and 24x20x16 (2,1,1) r1 of edge values
              (bf16, fp16, fp8); 8 steps of the fused loop with bf16 and with
              fp8 on the wire against phase 9's CPU loop; the main path
              with kernel_variant fused and wire_dtype="bfloat16" (75
              launches, all narrowed) beside the unnarrowed run in turns;
              the kernel timed per launch at 512^3 over 8 positions
              unnarrowed, bf16, fp8, fp8, bf16, unnarrowed; the fused loop
              with e5m2 on the wire too; then (variant_formats_phase) B8
              through every other format against its plain version by bit
              pattern at 24x20x16 (2,1,1) r1 of edge values and through e5m2
              and e4m3 at 512^3 (2,2,2) r1, the fused main path through each
              of the two (75 launches, all narrowed), and B8 timed per
              launch unnarrowed, e5m2, e4m3, e4m3, e5m2, unnarrowed.

11. guarded -- the guarded main path (guarded_phase): the fused health
              reduction (csrc/health_reduce.cu) against its plain version
              (the torch passes; finite flags torch.equal, max |x| equal
              with NaN equal to NaN) in fp32 and fp64 at 512^3 r1 one block,
              67x45x29 (also off the 16-byte grid) and 1 element, with NaN
              only, inf only, NaN + inf, -inf and a subnormal maximum; per
              lane on the campaign stacks B=64 of 128^3 and B=70,000 of 4^3;
              an 8-position mesh state; a dict of fp32 + fp64 + int32
              quantities; each timed per launch at 512^3 (fp32, fp64), B=64
              of 128^3 and the mesh beside its bytes bound, the torch
              passes and torch.linalg.vector_norm(ord=inf); the headline leg
              (python -m stencil_tpu_torch.apps.bench_headline, jacobi3d
              512^3 in 3 chunks of 360 with a health check each) in a
              subprocess, its JSON line printed; one guarded 360-step chunk
              at 512^3 with launch counts reset around it (120 multistep, 0
              sweeps, 1 health launch); jacobi3d 128^3 guarded (health and
              checkpoints every 2 steps) with nan@3 (3 fill launches in the
              restore's exchange) and ckpt-truncate@5,nan@5 equal to the
              clean run, exhaustion exiting 43 with its evidence file, a
              child killed after its step-4 snapshot and resumed equal to
              the uninterrupted run; astaroth 64^3 fp64 with nan@2 in lnrho
              equal to its clean run.
12. uneven -- uneven (remainder) partitions (uneven_phase): B6's uneven
              ring (each block's hi slab and hi halo at its own size, the
              pointers moved per block) against its plain version with
              torch.equal on every cell of every position at 512^3 over 6
              positions (3,2,1) r1, 67x45x29 (3,2,1) unaligned, 100x70x61
              (2,3,1) with face radii x 2/1, y 1/2, z 1/1 and 512x64x32 over
              5 positions (103/103/102/102/102), fp32 and fp64, unnarrowed
              and through bf16 (fp64 also fp32) by bit pattern; each ring
              phase timed per launch at 512^3 (3,2,1) r1 beside its bytes
              bound and sector floor, with the uniform x phases of
              513x512x512 (3,2,1) (the same padded pitch, also in turns
              with the uneven one) and 512^3 (2,2,2); the resident uneven
              exchange (512^3 (3,2,1) r3 x4, 13x11x9 (2,2,2) r2 fp64) on the
              card against the CPU, every cell, and in GB/s; 8 steps from a
              random field over 6 positions (plain, fused) and (3,2,1)
              residents, bit-equal to the single-block default path; the
              main paths apps.jacobi3d.run at 512^3 strong over 6 positions
              (plain: 2 remote_axis, 1 fill and 1 sweep of the 6 positions
              a step; fused, the host schedule: also 1 launch of their 36
              shells a step) and over
              (3,2,1) residents (1 sweep, 1 fill a step, no multistep),
              launch counts reset around each; a guarded jacobi3d at 128^3
              over 6 positions with nan@3 rolled back, equal to the clean
              run; a checkpoint written on (3,2,1) restored on (2,2,2).
13. float64 -- Jacobi in fp64 on the card (fp64_phase): the fp64
              instantiations of the sweep (B1) and the multistep (B2/B3)
              against their plain versions with torch.equal: B1 at phase
              2's one-block shapes with random sel on every plane and on 6
              planes and the spheres on their planes, the tenant stacks of
              64 x 128^3 and 64 x 32^3 (pitches 130 and 34), the stacked
              (2,2,2) r4 sweep of 512^3 and its 48 shells, the 8 positions
              of 256^3, the 6 uneven positions of 512^3 and their 36
              shells; B2 at every k = 1..6 on 67x45x29 and 130x70x40 (one
              and several z chunks) and its deep-halo form on (2,2,2) 512^3
              r4 at k = 2..4; each timed per launch at the main path's
              shape beside its plain version and its bound; 2k+2 steps at
              512^3 bit-equal to the plain versions; the fp64 main paths
              apps.jacobi3d.run(512, 512, 512, dtype="float64") on one
              block (24 multistep passes and 3 sweeps, as fp32), over
              (2,2,2) residents with deep halo 4 and 1, over 8 positions
              and over 6 uneven positions (plain and fused), and the
              campaign CLI's A/B --dtype float64 --check-parity at 64
              tenants of 128^3 and of 32^3 (its kernel build reported
              outside the timed spans), launch counts reset around each.
14. astaroth-resident -- Astaroth over resident blocks
              (astaroth_resident_phase, rehearsable on the CPU at small
              sizes with a stand-in timer): the substep kernel's table form
              (substep_tasks) against its plain version with torch.equal in
              fp64 and fp32, stages 0-2, over every block of stacks ragged
              against its 32x4 tile (40x24x20 over (2,2,2), 33x13x14 over
              (1,1,2)) and of the uneven 67x45x29 over (2,2,2), the 48-shell
              tables of 64^3 and of the uneven partition (tensor-copy and
              cp.async tasks in one launch), and fp64 fields off 16-byte
              alignment; apps.astaroth.run(partition=(2,2,2)) at the conf's
              256^3 a block in fp64 and fp32 and at nx=128 with overlap and
              without, in turns, launch counts reset around each (4 table
              launches an iteration with overlap, one of them the shells; 3
              without); a small resident run and an uneven step on the card
              against the CPU; the table launch over 8 residents of 256^3,
              its 48 shells and the 8-field fp64 exchange timed beside
              their bounds and plain versions.
15. surface -- the rest of the one-card exchange surface (surface_phase,
              rehearsable on the CPU at small sizes with a stand-in timer):
              DIRECT26 and REMOTE_DMA over (2,2,2) residents at 512^3 fp32
              r1, each bit-equal to AXIS_COMPOSED's exchange on the same
              state (every compute and halo cell; REMOTE_DMA every cell),
              in ms and GB/s logical with their launch counts (REMOTE_DMA:
              3 remote_axis, every block an endpoint; DIRECT26: no kernel),
              and DIRECT26 on an uneven 67x45x29 (2,2,2) r2 fp32 + fp64
              state on the card against the CPU, every cell; remote_axis
              over the 8 resident endpoints against its plain version,
              timed per phase; 8 blocks on 4 positions (2,2,1), bit-equal
              to the resident exchange (3 launches); 8 direct26 steps from
              a random field bit-equal to the plain versions and to the
              resident axis-composed path; the stacked no-wrap sweep of
              the direct26 step against its plain version and timed; the
              main paths jacobi3d 512^3 over (2,2,2) with --direct26 (one
              sweep launch a step, nothing else), with remote-dma (3
              remote_axis and one sweep a step) and with remote-dma on 4
              positions (3 remote_axis and one sweep of the 8 blocks a
              step), 50 iters in chunks of 25, launch counts reset around
              each, the three final fields equal; --multistep-rows at the
              kernel's tile heights (32 rows at k=3, 16 at k=4: kernel
              torch.equal to the plain multistep; the loop with rows=32
              equal to the default loop; 16 at k=3 refused); B9's uneven
              form at 512^3 over 6 positions (3,2,1), k=4 and a depth-3
              tail, torch.equal to persistent_jacobi_mesh_plain (both
              buffers and sel), timed by CUDA events beside its bytes bound
              and the deep exchange before it, 8 steps bit-equal to the
              single-block default path, and jacobi3d 512^3 over those 6
              positions with kernel_variant persistent, deep_halo 4 (48
              iters in chunks of 24: 18 chunk launches of the uneven form,
              42 remote_axis and 21 fills, 2 launches a chunk).
16. tenants -- the serving path (tenants_phase, rehearsable on the CPU at
              small sizes with a stand-in timer): B5's tenant form (one task
              a tenant of a (B, pz, py, px) stack) against its plain version
              with torch.equal, fp64 and fp32, stages 0-2, random fields at
              dt 0.1, at 64 x 32^3, 5 x 33x13x7 (odd pitch: no tensor
              copies) and 300 x 6x5x4 (two launches a stage), each lane of
              the first two also equal to its one-block launch; B4's tenant
              form (x, y, z over 8 fields, z wrapping each tenant) against
              wrap_fill_batched at 64 x 32^3 fp64 and fp32 and 5 x 33x13x7;
              both timed per launch beside their bytes bounds and plain
              versions; apps.campaign --workload astaroth --mode batched at
              64 x 32^3 and 8 x 128^3 fp64 with t1 faulted and evicted,
              launch counts reset around each (3 fills and 3 substep
              launches an iteration), every retired tenant byte-equal to it
              stepped alone (B = 1), with tenant Mcells/s and p50/p99 step
              latency; the serving daemon in process (jacobi 32^3 and 64^3
              fp32 and astaroth 32^3 fp64 jobs, mixed priorities, a quota,
              a ledger-priced rejection, a second wave from the first chunk
              boundary, a slot grown mid-run): every job retired, its
              results/<job>.json written and its final field byte-equal to
              the batch CampaignDriver's, every record valid; a daemon
              drained mid-run and a second revived on its directory, no
              retired job re-run, every result byte-equal to the
              uninterrupted serve's.
17. astaroth-mesh -- Astaroth over a mesh of block positions
              (astaroth_mesh_phase, rehearsable on the CPU at small sizes
              with a stand-in timer): the substep's one-stack registers
              held to fp64 157 / 168 and fp32 77 / 80 with no spill, its
              positions form's printed (no spill); B5's positions form
              (one launch for up to 8 positions, each position's stacks
              its own allocation) against its plain version with
              torch.equal, stages 0-2 and the shells, at 8 x 128^3 fp64
              and fp32, uneven 67x45x29 over (2,2,2) in fp32 and in fp64
              with one position off 16-byte alignment, 12 positions of
              60x40x28 over (3,2,2) (two launches a stage) and (2,2,2) on
              2 positions; the step over 8 positions of 128^3 fp64 (overlap
              and not), the mixed (1,1,2) over 2 positions (B4 on x and
              y), (2,2,2) on 4 positions and the uneven split, each equal
              cell for cell to the same run over resident blocks, and
              make_fused_astaroth_loop (B7) equal to the composed mesh
              step, launch counts held (4 positions launches an iteration
              with overlap, B6's axis phases, B7 once); one exchange of
              the 8 fp64 fields by B6 and by B7 over 8 positions of 256^3
              and by B6 and B4 over the (1,1,2) mesh, each equal on every
              compute and halo cell to the resident exchange, timed; apps.astaroth.run
              over 8 positions at 256^3 a position in fp64 (with overlap
              and without) with launch counts, beside the resident
              55.6269 ms/iter; the positions launch over 8 x
              256^3 fp64 and its 48 shells timed beside their plain
              versions and bounds, and the resident table launch over the
              same cells in the same call.

18. plan -- the exchange planner (plan_phase, rehearsable on the CPU at
              small sizes): apps.jacobi3d.run at 512^3 fp32 with
              autotune=True and a plan DB in a temporary directory on one
              device (each candidate's static cost and each probe's
              trimean printed, no probe failed, launches held to the
              probes', the chosen plan's loop and the attribution
              epilogue's), again as a DB hit (zero probes, the same
              choice); the same over 8 positions of 512^3 (REMOTE_DMA plain
              and fused over the partitions of 8; B6, B7 and B4 under the
              probes); a guarded loop over 8 positions on the plain plan
              (B1 + B6) with a sentinel, a status file and a
              ReplanController latched after chunk 2 whose re-tune returns
              the fused choice (B8 after the swap, B7 for the swap's
              exchange; launches held before and after, replan.applied
              recorded, the status file valid, the compute region
              torch.equal to an unswapped run); plan_tool calibrate
              --platform cuda on the 8-position runs' metrics (the fitted
              row printed, the mesh config re-ranked with it, the static
              winner beside the measured one); apps.astaroth.run at 256^3
              fp64 with autotune=True; the serving daemon in process with
              --replan, --plan-db, --status-file and --live-sentinel (SLO
              pressure swaps between slots; every result byte-equal to the
              batch driver's). The kernels line's rows carry the phase's
              launches as plan_phase_launches.
19. tools -- the measurement tools (tools_phase, rehearsable on the CPU at
              small sizes): obs.xprof.capture (a torch.profiler capture)
              around apps.jacobi3d.run at 512^3 fp32 on one block (a warm-up
              and one 25-step chunk) and over 8 positions (plain
              remote-dma): the gate yields True, the dump is parsed,
              range_seconds gives jacobi.chunk device seconds, each kernel's
              events (matched by its __global__ name) equal its wrapper's
              launch counter around the run and one chunk's inside the
              chunk's device span, the multistep's profiler mean within 15%
              of its CUDA-event time, the top five kernels and the
              chunk's device busy share printed; a capture of B8's and B9's
              cooperative mesh launches, the health kernel and a CUDA
              graph's replay (what does not show is printed); the record
              tools on the one-block run's metrics file (trace export valid,
              report --validate 0, the chunk spans, perf_tool ingest under
              two labels, trend, gate 0 or 1); apps.bench_exchange (the
              radius sweep at 256^3 x4, B4's launches held; the ablation over
              (2,2,2) residents bit for bit, census 6 / 26 / 0, auto-spmd
              skipped; config 2 over 8 positions by B6 and B7, launches
              held; the bf16 wire A/B's gate); apps.bench_pack at 512^3 r3
              (26 rows, each direction's bytes); apps.measure_overlap at
              512^3 over 8 positions with --trace (hidden_frac, the sweep
              kernel in the trace). The B2 and B1 rows of the kernels line
              carry the profiler's mean ms as profiler_ms.

It then prints the card (nvidia-smi name and power limit), a
{"kernels": [...]} line, and as its last line
{"ok": true, "device": {...}}. Without a visible GPU it exits non-zero
before printing any result.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def guarded_phase(dev, time_ms, n: int = 512, stacks=((64, 128), (70000, 4)), gn: int = 128,
                  an: int = 64, headline: bool = True):
    """Phase 11, the guarded main path, on ``dev``: the health kernel against
    its plain version (and timed), the headline leg in a subprocess, one
    guarded 360-step chunk with launch counts, the guarded jacobi3d and
    astaroth rollbacks, the truncated-snapshot fallback, exhaustion and a
    kill-and-resume. Sizes are arguments so that the phase can be rehearsed
    small on the CPU (``time_ms`` then a stand-in). Returns the health
    kernel's ``(timing, launches, max_abs_err)``."""
    from stencil_tpu_torch.apps import astaroth as astaroth_app
    from stencil_tpu_torch.apps import bench_headline, ckpt_tool, jacobi3d
    from stencil_tpu_torch.astaroth.integrate import FIELDS
    from stencil_tpu_torch.domain import GridSpec
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import halo_fill, health_reduce as hr, stencil_kernels as sk
    from stencil_tpu_torch.utils.roofline import bound_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(1100)

    def rand(shape, dtype=torch.float32):
        return (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) - 0.5).to(dtype)

    def plain(groups, per_lane=False):
        """The torch passes on the same tensors, on the card."""
        finite, amax = zip(*(hr.finite_and_max_plain(hr._joined(g, per_lane),
                                                     1 if per_lane else None) for g in groups))
        return torch.stack([torch.stack(finite), torch.stack(amax)])

    def library(groups, per_lane=False):
        """One PyTorch call a tensor for max |x| (NaN propagating), whose
        finiteness is the flag: torch.linalg.vector_norm(ord=inf)."""
        return [torch.linalg.vector_norm(t.reshape(t.shape[0], -1) if per_lane else t,
                                         float("inf"), dim=1 if per_lane else None)
                for g in groups for t in g]

    err = 0.0

    def held(label, groups, per_lane=False):
        nonlocal err
        got = hr.health_reduce(groups, per_lane)
        want = plain(groups, per_lane)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"health {label}: finite flags differ")
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"health {label}: max |x| differs: {m}")
        both = torch.isfinite(got[1]) & torch.isfinite(want[1])
        if bool(both.any()):
            err = max(err, float((got[1][both] - want[1][both]).abs().max()))
        log(f"health {label}: == plain (finite {got[0].flatten()[:4].tolist()}, "
            f"max {got[1].flatten()[:4].tolist()})")

    pad = GridSpec(Dim3(n, n, n), Dim3(1, 1, 1), Radius.constant(1)).stacked_shape_zyx()
    for dt in (torch.float32, torch.float64):
        x = rand(pad, dt)
        held(f"{n}^3 r1 one block {dt}", [[x]])
        del x
        y = rand((29, 45, 67), dt) * 7
        held(f"67x45x29 {dt}", [[y]])
        held(f"67x45x29 off the 16-byte grid {dt}", [[y.reshape(-1)[1:]]])
        held(f"1 element {dt}", [[torch.full((1,), -3.5, device=dev, dtype=dt)]])
        tiny = torch.finfo(dt).tiny / 4  # a subnormal
        for label, vals in (("NaN only", [float("nan")]), ("inf only", [float("inf")]),
                            ("NaN + inf", [float("nan"), float("inf")]),
                            ("-inf", [float("-inf")]), ("subnormal max", [tiny])):
            z = torch.zeros((17, 33, 65), device=dev, dtype=dt)
            if label != "subnormal max":
                z += 0.25
            for i, v in enumerate(vals):
                z.view(-1)[1000 + 5000 * i] = v
            held(f"{label} {dt}", [[z]])
    for b, e in stacks:
        p = GridSpec(Dim3(e, e, e), Dim3(1, 1, 1), Radius.constant(1), aligned=False).padded()
        st = rand((b, p.z, p.y, p.x))
        st[b // 3, 2, 2, 2] = float("nan")
        st[b // 2, 1, 1, 1] = float("-inf")
        st[b - 1, 3, 3, 3] = 1e30
        held(f"campaign stack B={b} of {e}^3 per lane", [[st]], per_lane=True)
        del st
    mesh = [rand((1, 1, 1, 66, 72, 66)) for _ in range(8)]
    mesh[5][0, 0, 0, 9, 9, 9] = 9.0
    held("8-position mesh state", [mesh])
    d = {"a": rand((20, 30, 40)), "b": rand((20, 30, 40), torch.float64),
         "c": torch.ones((20, 30, 40), dtype=torch.int32, device=dev)}
    held("fp32 + fp64 + int32 dict", [[d[k]] for k in sorted(d)])

    # per launch beside the bytes bound, the torch passes and one library call
    x = rand(pad)
    b0, e0 = stacks[0]
    p = GridSpec(Dim3(e0, e0, e0), Dim3(1, 1, 1), Radius.constant(1), aligned=False).padded()
    st = rand((b0, p.z, p.y, p.x))
    cases = {f"{n}^3": ([[x]], False), f"{n}^3 fp64": ([[x.double()]], False),
             f"B={b0} of {e0}^3": ([[st]], True), "8-position mesh": ([mesh], False)}
    times = {}
    for label, (groups, pl) in cases.items():
        nbytes = hr.health_bytes(groups)
        times[label] = dict(
            ms=time_ms(lambda: hr.health_reduce(groups, pl), 20),
            plain_ms=time_ms(lambda: plain(groups, pl), 5),
            library_ms=time_ms(lambda: library(groups, pl), 5),
            bound=bound_ms(nbytes, nbytes // groups[0][0].element_size()))
        t = times[label]
        log(f"time health_reduce {label}: {t['ms']:.4f} ms per launch (torch passes "
            f"{t['plain_ms']:.4f} ms, vector_norm(inf) {t['library_ms']:.4f} ms, bound "
            f"{t['bound'][0]:.4f} ms by {t['bound'][1]})")
    del x, st, mesh
    main_t = times[f"{n}^3"]
    lanes = times[f"B={b0} of {e0}^3"]
    timing = dict(main_t, extra={"lanes_ms": lanes["ms"], "lanes_plain_ms": lanes["plain_ms"],
                                 "lanes_library_ms": lanes["library_ms"],
                                 "lanes_bound_ms": lanes["bound"][0]})

    # the main path: one guarded chunk of the headline job (360 steps, a
    # health check at its end), launch counts set to 0 just before
    counted = {"jacobi_multistep": sk.multistep, "jacobi_sweep": sk.sweep,
               "self_fill": halo_fill.self_fill, "health_reduce": hr.health_reduce}
    for fn in counted.values():
        fn.launches = 0
    r = jacobi3d.run(n, n, n, iters=360, chunk=360, health_every=360, warmup=0, weak=False,
                     device=dev)
    got = {k: fn.launches for k, fn in counted.items()}
    k = r["temporal_k"]
    want = {"jacobi_multistep": 360 // k, "jacobi_sweep": 360 % k, "self_fill": 0,
            "health_reduce": 1}
    check(got == want and r["health_checks"] == 1,
          f"guarded chunk of {n}^3: launches {got}, expected {want}")
    health_launches = got["health_reduce"]
    log(f"guarded chunk of {n}^3, 360 steps at k={k}: launches {got}, "
        f"{r['iter_trimean_s'] * 1e3:.4f} ms/iter, loop wall {r['loop_wall_s']:.4f} s")
    del r

    if headline:
        # the headline leg as a user runs it
        env = dict(os.environ)
        env.pop("STENCIL_BENCH_CKPT_DIR", None)
        root = os.path.dirname(os.path.abspath(__file__))
        hp = subprocess.run([sys.executable, "-m", "stencil_tpu_torch.apps.bench_headline"],
                            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        check(hp.returncode == 0, f"bench_headline rc {hp.returncode}: {hp.stderr[-2000:]}")
        row = json.loads(hp.stdout.strip().splitlines()[-1])
        check(row["value"] > 0 and row["health_checks"] == 3 and row["device"] != "cpu",
              f"bench_headline row {row}")
        log(f"bench_headline: {json.dumps(row)}")

    with tempfile.TemporaryDirectory(prefix="chip-smoke-guarded-") as tmp:
        # a guarded jacobi3d on the card: the NaN at step 3 is rolled back
        # to the step-2 snapshot and recomputed, equal to the clean run
        kw = dict(iters=8, weak=False, health_every=2, ckpt_every=2, rollback_backoff=0.01,
                  device=dev)

        def field(r):
            return r["domain"].get_curr_global(r["handle"])

        clean = field(jacobi3d.run(gn, gn, gn, ckpt_dir=os.path.join(tmp, "clean"), **kw))
        check(bool(np.isfinite(clean).all()), "guarded jacobi3d clean run: non-finite")
        for fn in counted.values():
            fn.launches = 0
        faulted = jacobi3d.run(gn, gn, gn, ckpt_dir=os.path.join(tmp, "nan"), inject="nan@3",
                               **kw)
        got = {k: fn.launches for k, fn in counted.items()}
        check(np.array_equal(field(faulted), clean),
              f"guarded jacobi3d {gn}^3 nan@3: != the clean run")
        # the restore's exchange fills the halos (3 fill launches on one block)
        check(got["self_fill"] == 3 and got["health_reduce"] >= 5,
              f"guarded jacobi3d {gn}^3 nan@3: launches {got}")
        log(f"guarded jacobi3d {gn}^3 nan@3: rolled back, == the clean run; launches {got}")
        del faulted
        trunc = jacobi3d.run(gn, gn, gn, ckpt_dir=os.path.join(tmp, "trunc"),
                             inject="ckpt-truncate@5,nan@5", **kw)
        check(np.array_equal(field(trunc), clean),
              f"guarded jacobi3d {gn}^3 ckpt-truncate@5,nan@5: != the clean run")
        log(f"guarded jacobi3d {gn}^3 ckpt-truncate@5,nan@5: fell back past the truncated "
            "snapshot, == the clean run")
        del trunc
        ck = os.path.join(tmp, "exhaust")
        rc = jacobi3d.main(["--x", str(gn), "--y", str(gn), "--z", str(gn), "--no-weak",
                            "--iters", "8", "--device", str(dev), "--ckpt-dir", ck,
                            "--ckpt-every", "2", "--health-every", "2", "--max-rollbacks", "1",
                            "--rollback-backoff", "0.01", "--inject", "nan@3:repeat=always"])
        ev = os.path.join(ck, "fault-evidence.json")
        check(rc == 43 and os.path.isfile(ev) and json.load(open(ev))["rc"] == 43,
              f"guarded jacobi3d exhaustion: rc {rc}, evidence {os.path.isfile(ev)}")
        log("guarded jacobi3d exhaustion: rc 43 with its evidence file")

        # kill-and-resume: a child dies right after its step-4 snapshot is
        # durable, a second one resumes; the end equals the clean run's
        root = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, "-m", "stencil_tpu_torch.apps.jacobi3d", "--x", str(gn),
               "--y", str(gn), "--z", str(gn), "--no-weak", "--iters", "8", "--device",
               str(dev), "--ckpt-dir", os.path.join(tmp, "killed"), "--ckpt-every", "2",
               "--health-every", "2"]
        env = dict(os.environ, STENCIL_CKPT_KILL_AFTER_SAVE="4")
        p1 = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=600)
        env.pop("STENCIL_CKPT_KILL_AFTER_SAVE")
        p2 = subprocess.run(cmd + ["--resume"], cwd=root, env=env, capture_output=True,
                            text=True, timeout=600)
        check(p1.returncode == 17 and p2.returncode == 0
              and "resuming from checkpointed step 4" in p2.stderr,
              f"kill-and-resume: rc {p1.returncode} then {p2.returncode}: {p2.stderr[-2000:]}")
        check(ckpt_tool.main(["diff", "--data", os.path.join(tmp, "killed"),
                              os.path.join(tmp, "clean")]) == 0,
              "kill-and-resume: the resumed run's final snapshot != the clean run's")
        log(f"kill-and-resume {gn}^3: killed after step 4 (rc 17), resumed, final snapshot "
            "== the uninterrupted run's")

        # the guarded astaroth: a NaN in lnrho at step 2 rolled back
        akw = dict(iters=3, nx=an, chunk=1, ckpt_every=1, health_every=1,
                   rollback_backoff=0.01, device=dev)
        aclean = astaroth_app.run(ckpt_dir=os.path.join(tmp, "aclean"), **akw)
        anan = astaroth_app.run(ckpt_dir=os.path.join(tmp, "anan"), inject="nan@2:q=lnrho",
                                **akw)
        for name in FIELDS:
            a = anan["domain"].get_curr_global(anan["handles"][name])
            b = aclean["domain"].get_curr_global(aclean["handles"][name])
            check(bool(np.isfinite(a).all()) and np.array_equal(a, b),
                  f"guarded astaroth {an}^3 nan@2: {name} != the clean run")
        log(f"guarded astaroth {an}^3 fp64 nan@2: rolled back, every field == the clean run")
    return timing, health_launches, err


# the narrowed wire's edge values: fp8's overflow edge (448 its largest
# value, 464 the tie that rounds to it, NaN above), its subnormals and their
# ties, fp16's overflow edge, ties at 1, values fp64 rounds once differently
# from twice, fp32 subnormals, the non-finite values
WIRE_EDGES = [0.0, -0.0, 1.0, 448.0, -448.0, 460.0, 464.0, -464.0, 465.0, 480.0, 500.0, 1e30,
              -1e30, float("inf"), float("-inf"), float("nan"), 2.0 ** -6, 2.0 ** -9, 2.0 ** -10,
              -(2.0 ** -10), 3 * 2.0 ** -11, 3 * 2.0 ** -10, 65504.0, 65519.0, 65520.0, 65536.0,
              1 + 2.0 ** -8, 1 + 3 * 2.0 ** -9, 1 + 2.0 ** -4, 2.0 ** -24, 2.0 ** -25, 2.0 ** -14,
              1e-40, -1e-40, 1e-45, 2.0 ** -10 + 2.0 ** -40, 1 + 2.0 ** -4 + 2.0 ** -40,
              1 + 2.0 ** -11 + 2.0 ** -40, 1 + 2.0 ** -8 + 2.0 ** -30, 0.1, 1 / 3]
BF16, FP8 = "bfloat16", "float8_e4m3fn"
# the formats the port narrows through beside bf16, fp16, e4m3fn and fp32:
# e5m2 by the card's conversion, the others by the SOFT instantiation
# (csrc/wire_round.cuh); SOFT_TIMED is the software format timed beside e5m2
NEW_WIRES = ("float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e4m3b11fnuz",
             "float8_e3m4", "float8_e4m3", "float8_e8m0fnu", "float4_e2m1fn")
E5M2, SOFT_TIMED = "float8_e5m2", "float8_e4m3"


def b1_times(time_ms, dev, run, plain, nbytes, reps: int = 20, plain_reps: int = 3,
             dtype=torch.float32) -> dict:
    """A B1 form's device ms per launch (CUDA-graph replay) beside its plain
    version's; its bound with sel read on its sel planes (the bytes the call
    needs; ``nbytes`` = (every plane, sel on its planes), as
    ``stencil_kernels.sweep_bytes`` counts them for ``dtype``'s cells: 12
    bytes a cell in fp32, 20 in fp64 with sel on every plane); the bound
    with sel on every plane; and a three-stream torch.add of ``dtype`` over
    as many cells."""
    from stencil_tpu_torch.utils.roofline import bound_ms

    full, ranged = nbytes
    n = full // (2 * torch.empty((), dtype=dtype).element_size() + 4)
    a, b, o = (torch.rand(n, device=dev, dtype=dtype) for _ in range(3))
    add_ms = time_ms(lambda: torch.add(a, b, out=o), reps, graph=True)
    del a, b, o
    return dict(ms=time_ms(run, reps, graph=True), plain_ms=time_ms(plain, plain_reps, warmup=1),
                bound=bound_ms(ranged, 6 * n, dtype), library_ms=None,
                extra={"bound_every_plane_ms": bound_ms(full, 6 * n, dtype)[0],
                       "add_ms": add_ms})


def b1_log(name: str, t: dict, what: str) -> None:
    log(f"time {name} {what}: {t['ms']:.4f} ms per launch (plain {t['plain_ms']:.4f} ms, "
        f"bound {t['bound'][0]:.4f} ms with sel on its planes, "
        f"{t['extra']['bound_every_plane_ms']:.4f} ms with sel on every plane; torch.add of as "
        f"many cells {t['extra']['add_ms']:.4f} ms)")


def bits_equal(x: torch.Tensor, y: torch.Tensor):
    """``(equal, nan_patterns)``: the bit patterns of ``x`` and ``y`` equal,
    every NaN taken as one pattern (the card's widened NaN is the
    conversion's canonical NaN, torch's keeps its own: the plain version
    pins where a NaN is, not its bits); ``nan_patterns`` counts the NaNs
    whose raw bits differ."""
    if not x.is_floating_point():
        return bool(torch.equal(x, y)), 0
    it = torch.int32 if x.element_size() == 4 else torch.int64
    ix, iy = x.view(it), y.view(it)
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(((ix == iy) | (nx & ny)).all()), int(((ix != iy) & nx & ny).sum())


def wire_err(x: torch.Tensor, y: torch.Tensor) -> float:
    """max |x - y| over the cells where neither is NaN (0 when none)."""
    keep = ~(torch.isnan(x) | torch.isnan(y)) if x.is_floating_point() else None
    d = (x.double() - y.double()).abs()
    d = d[keep] if keep is not None else d
    return float(d.max()) if d.numel() else 0.0


def mesh_wire_phase(dev, time_ms, n: int = 512, c2: int = 256, steps: int = 8, iters: int = 50,
                    chunk: int = 25):
    """Phase 9's narrowed wire (``wire_dtype``), on ``dev``: B6 and B7 with
    a wire against their plain versions, by bit pattern on every cell of
    every position (NaN as one pattern), at config 2 (``c2``^3 (2,2,2) r2 x4
    fp32) and ``n``^3 (2,2,2) r1 at bf16 and fp8, 128^3 (2,2,2) r2 x2 fp64
    and 66x20x16 (2,1,1) r2 x2 fp64 at float32 and bf16, a 64^3 fp32 + fp64
    + int32 dict (int32 copied bitwise), and every (data, wire) pair on
    fields of edge values at 32^3; each case's whole mesh exchange, plain and
    fused, on the card against the same exchange on the CPU; ``steps`` steps
    at ``n``^3 over 8 positions through the plain loop with bf16, fp8
    e4m3fn, e5m2 and :data:`SOFT_TIMED` on the wire against the same loop on
    the CPU (kept for phase 10's fused loop); the main path ``apps.jacobi3d.run(n, n, n, devices=[dev] * 8,
    method=REMOTE_DMA, wire_dtype="bfloat16")`` with launch counts reset
    around it (those of the unnarrowed run, every B6 launch narrowed),
    beside the unnarrowed run in turns; B6 per phase at config 2 and ``n``^3
    r1 and B7 at config 2 timed per launch unnarrowed, bf16, fp8, fp8, bf16,
    unnarrowed; ``exchange_loop`` at config 2 through each carrier with and
    without a wire. Sizes are arguments so that the phase can be rehearsed
    on the CPU. Returns ``(timings, launches, errs, cpu_refs)``."""
    from stencil_tpu_torch import DistributedDomain, GridSpec
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.ops import halo_fill
    from stencil_tpu_torch.ops import remote_dma as rdma
    from stencil_tpu_torch.ops import stencil_kernels as sk
    from stencil_tpu_torch.ops.jacobi import make_jacobi_loop, sphere_sel_blocks
    from stencil_tpu_torch.parallel import DeviceMesh, HaloExchange, Method, unshard_blocks
    from stencil_tpu_torch.plan.ir import build_plan
    from stencil_tpu_torch.utils.roofline import bound_ms

    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev)
    rdma_m = Method.REMOTE_DMA

    def rspec(size, part, r):
        return GridSpec(Dim3(*size), Dim3(*part), Radius.constant(r))

    def mesh_of(spec, device=dev):
        return DeviceMesh(spec.dim, [device] * spec.dim.flatten())

    def wide_mesh(spec, dtypes, seed, edges=False):
        """{q: [block per position]}: random sign and magnitude 2^U(-12, 9)
        (fp8's subnormals to past its overflow), or edge values, in every
        cell; an int32 quantity random integers."""
        p = spec.padded()
        shape = (1, 1, 1, p.z, p.y, p.x)
        vals = torch.tensor(WIRE_EDGES, dtype=f64, device=dev)
        out = {}
        for q, dt in enumerate(dtypes):
            gen.manual_seed(seed + q)
            blocks = []
            for _ in range(spec.num_blocks()):
                if dt == i32:
                    b = torch.randint(-2 ** 30, 2 ** 30, shape, generator=gen, device=dev,
                                      dtype=i32)
                elif edges:
                    b = vals[torch.randint(len(WIRE_EDGES), shape, generator=gen, device=dev)]
                else:
                    b = torch.randn(shape, generator=gen, device=dev, dtype=f64) * torch.exp2(
                        torch.rand(shape, generator=gen, device=dev, dtype=f64) * 21 - 12)
                blocks.append(b.to(dt))
            out[q] = blocks
        return out

    def cloned(groups):
        return [[b.clone() for b in g] for g in groups]

    errs = {"remote_axis_wire": 0.0, "fused_exchange_wire": 0.0}
    nan_patterns = 0

    def held(name, label, got, want):
        nonlocal nan_patterns
        res = [bits_equal(a, b) for ga, gb in zip(got, want) for a, b in zip(ga, gb)]
        nan_patterns += sum(k for _e, k in res)
        check(all(e for e, _k in res), f"{name} {label}: kernel != plain (bit patterns, NaN as "
              "one pattern)")
        errs[name] = max(errs[name], max(wire_err(a, b) for ga, gb in zip(got, want)
                                         for a, b in zip(ga, gb)))

    cases = [
        (f"config 2: {c2}^3 (2,2,2) r2 x4 fp32", rspec((c2,) * 3, (2, 2, 2), 2), [f32] * 4,
         (BF16, FP8), False),
        (f"{n}^3 (2,2,2) r1 fp32", rspec((n,) * 3, (2, 2, 2), 1), [f32], (BF16, FP8), False),
        ("128^3 (2,2,2) r2 x2 fp64", rspec((128,) * 3, (2, 2, 2), 2), [f64, f64],
         ("float32", BF16), False),
        ("66x20x16 (2,1,1) r2 x2 fp64", rspec((66, 20, 16), (2, 1, 1), 2), [f64, f64],
         ("float32", BF16), False),
        ("64^3 (2,2,2) r1 fp32 + fp64 + int32", rspec((64,) * 3, (2, 2, 2), 1), [f32, f64, i32],
         (BF16, FP8), False),
        ("edge values 32^3 (2,2,2) r2 fp32", rspec((32,) * 3, (2, 2, 2), 2), [f32],
         (BF16, "float16", FP8), True),
        ("edge values 40x36x20 (1,2,2) r1 fp64", rspec((40, 36, 20), (1, 2, 2), 1), [f64],
         ("float32", BF16, "float16", FP8), True),
    ]
    for i, (label, spec, dts, wires, edges) in enumerate(cases):
        mesh, cpu_mesh = mesh_of(spec), mesh_of(spec, cpu)
        st = wide_mesh(spec, dts, 600 + 10 * i, edges)
        plan = build_plan(spec, spec.dim, rdma_m)
        fplan = build_plan(spec, spec.dim, rdma_m, fused=True)
        for wire in wires:
            for dt in dict.fromkeys(dts):
                start = [[st[k][j] for k, d in enumerate(dts) if d == dt]
                         for j in range(spec.num_blocks())]
                for ph in plan.remote_phases:
                    if ph.ring < 2 or not ph.active:
                        continue
                    got = rdma.remote_axis(cloned(start), spec, ph, mesh, wire)
                    want = rdma.remote_axis_plain(cloned(start), spec, ph, mesh, wire)
                    held("remote_axis_wire", f"{label} {dt} {ph.axis} {wire}", got, want)
                got = fst.fused_exchange(cloned(start), spec, fplan, mesh, wire)
                want = fst.fused_exchange_plain(cloned(start), spec, fplan, mesh, wire)
                held("fused_exchange_wire", f"{label} {dt} {wire}", got, want)
            for fused in (False, True):
                on_card = {q: [b.clone() for b in bl] for q, bl in st.items()}
                on_cpu = {q: [b.cpu() for b in bl] for q, bl in st.items()}
                HaloExchange(spec, rdma_m, mesh=mesh, fused=fused, wire_dtype=wire)(on_card)
                HaloExchange(spec, rdma_m, mesh=cpu_mesh, fused=fused, wire_dtype=wire)(on_cpu)
                for q in st:
                    check(all(bits_equal(a.cpu(), b)[0] for a, b in zip(on_card[q], on_cpu[q])),
                          f"mesh exchange {label} fused={fused} {wire} q{q}: card != CPU")
                del on_card, on_cpu
        log(f"mesh {label} through {', '.join(wires)}: remote_axis and fused_exchange == plain "
            "(bit patterns, every cell); both exchanges on the card == the CPU")
        del st
    log(f"wire checks of phase 9: {nan_patterns} NaN cells whose widened bits differ between the "
        "card and the plain version (NaN as one pattern: the card's conversions give their "
        "canonical NaN)")

    # steps at n^3 over 8 positions through the plain loop with a wire, on
    # the card against the CPU (the field is in [0, 1), inside fp8's range):
    # bf16, e4m3fn and e5m2 by the card's conversions, SOFT_TIMED by the
    # SOFT instantiation
    spec1 = rspec((n,) * 3, (2, 2, 2), 1)
    mesh8, cpu8 = mesh_of(spec1), mesh_of(spec1, cpu)
    gen.manual_seed(630)
    g = torch.rand((n, n, n), generator=gen, device=dev)
    cpu_refs = {}
    for wire in (BF16, FP8, E5M2, SOFT_TIMED):
        outs = []
        for mesh in (mesh8, cpu8):
            ex = HaloExchange(spec1, rdma_m, mesh=mesh, wire_dtype=wire)
            c = from_global(g, spec1, mesh)
            out, _ = make_jacobi_loop(ex, steps)(c, [torch.zeros_like(b) for b in c],
                                                 sphere_sel_blocks(spec1, mesh))
            outs.append(unshard_blocks(out, spec1))
            del ex, c, out
        check(np.array_equal(outs[0], outs[1]),
              f"jacobi {n}^3 {steps} steps over 8 positions with {wire} on the wire: card != CPU")
        cpu_refs[wire] = outs[1]
        log(f"jacobi {n}^3 {steps} steps over 8 positions (remote_axis + sweeps) with {wire} on "
            "the wire: card == CPU on every cell")
    cpu_refs["field"] = g

    # the main path with bf16 on the wire, beside the unnarrowed run in turns
    counted = {"remote_axis": rdma.remote_axis, "jacobi_sweep": sk.sweep,
               "jacobi_sweep_positions": sk.sweep_positions, "self_fill": halo_fill.self_fill,
               "jacobi_multistep": sk.multistep, "fused_exchange": fst.fused_exchange}
    launches, ms_iter = {}, {}
    run_steps = (iters + chunk) * (dev.type == "cuda")  # the CPU's plain versions launch nothing
    want = {"remote_axis": 3 * run_steps, "jacobi_sweep": 0, "jacobi_sweep_positions": run_steps,
            "self_fill": 0, "jacobi_multistep": 0, "fused_exchange": 0}
    hot, cold = (m.cpu() for m in sk.sphere_masks_from_coords(rspec((n,) * 3, (1, 1, 1), 1), dev))
    for wire in (None, BF16, BF16, None):
        for fn in counted.values():
            fn.launches = 0
        rdma.remote_axis.narrowed = 0
        rv = jacobi3d.run(n, n, n, devices=[dev] * 8, method=rdma_m, iters=iters, chunk=chunk,
                          weak=False, wire_dtype=wire)
        sync(dev)
        got = {name: fn.launches for name, fn in counted.items()}
        check(got == want and rdma.remote_axis.narrowed == (want["remote_axis"] if wire else 0),
              f"jacobi3d over 8 positions, wire {wire}: launches {got} "
              f"({rdma.remote_axis.narrowed} narrowed), expected {want}")
        fin = torch.from_numpy(rv["domain"].get_curr_global(rv["handle"]))
        check(bool(torch.isfinite(fin).all()) and float(fin.min()) >= 0.0
              and float(fin.max()) <= 1.0 and bool((fin[hot] == 1.0).all())
              and bool((fin[cold] == 0.0).all()),
              f"jacobi3d over 8 positions, wire {wire}: field not finite, out of range or "
              "spheres lost")
        ms_iter.setdefault(wire, []).append(rv["iter_trimean_s"] * 1e3)
        log(f"jacobi3d {n}^3 over 8 positions of one card (remote-dma, wire {wire}): "
            f"{rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), {rv['mcells_per_s']:.1f} "
            f"Mcells/s, launches {got}, narrowed remote_axis {rdma.remote_axis.narrowed}")
        if wire:
            launches["remote_axis_wire"] = rdma.remote_axis.narrowed
        del rv, fin
    log(f"jacobi3d {n}^3 over 8 positions, ms/iter in turns: unnarrowed "
        f"{', '.join(f'{v:.4f}' for v in ms_iter[None])}, bf16 on the wire "
        f"{', '.join(f'{v:.4f}' for v in ms_iter[BF16])}")

    # per launch, in turns: unnarrowed, bf16, fp8, fp8, bf16, unnarrowed
    turns = (None, BF16, FP8, FP8, BF16, None)
    timings = {}
    for label, spec, nq in ((f"config 2 ({c2}^3 (2,2,2) r2 x4)", rspec((c2,) * 3, (2, 2, 2), 2),
                             4), (f"{n}^3 (2,2,2) r1 x1", spec1, 1)):
        st = wide_mesh(spec, [f32] * nq, 640)
        groups = [[st[q][j] for q in range(nq)] for j in range(8)]
        mesh = mesh_of(spec)
        ring = [ph for ph in build_plan(spec, (2, 2, 2), rdma_m).remote_phases if ph.active]
        per = {w: [[] for _ in ring] for w in turns}
        for wire in turns:
            for k, ph in enumerate(ring):
                per[wire][k].append(time_ms(
                    lambda ph=ph, w=wire: rdma.remote_axis(groups, spec, ph, mesh, w), 20,
                    graph=True))
        for k, ph in enumerate(ring):
            b = bound_ms(rdma.remote_axis_bytes(spec, ph, nq, 8, 4), 0)[0]
            f = bound_ms(rdma.remote_axis_sector_bytes(spec, ph, nq, 8, 4), 0)[0]
            log(f"time remote_axis {label} {ph.axis} per launch in turns: "
                + "; ".join(f"{w or 'unnarrowed'} {', '.join(f'{v:.4f}' for v in per[w][k])}"
                            for w in dict.fromkeys(turns))
                + f" ms (bound {b:.4f} ms by bytes, sector floor {f:.4f} ms)")
        if nq == 4:
            mean = {w: sum(sum(v) / len(v) for v in per[w]) / len(ring) for w in per}
            nbytes = sum(rdma.remote_axis_bytes(spec, ph, nq, 8, 4) for ph in ring) / len(ring)
            plain = time_ms(lambda: [rdma.remote_axis_plain(groups, spec, ph, mesh, BF16)
                                     for ph in ring], 3) / len(ring)
            timings["remote_axis_wire"] = dict(
                ms=mean[BF16], plain_ms=plain, bound=bound_ms(nbytes, 0), library_ms=None,
                extra={"ms_unnarrowed": mean[None], "ms_fp8": mean[FP8]})
            fplan = build_plan(spec, (2, 2, 2), rdma_m, fused=True)
            fper = {w: [] for w in turns}
            for wire in turns:
                fper[wire].append(time_ms(
                    lambda w=wire: fst.fused_exchange(groups, spec, fplan, mesh, w), 20,
                    graph=True))
            fb = bound_ms(fst.fused_exchange_bytes(fplan, nq, 8, 4), 0)
            ff = bound_ms(fst.fused_exchange_sector_bytes(fplan, spec, nq, 8, 4), 0)[0]
            log(f"time fused_exchange {label} per launch in turns: "
                + "; ".join(f"{w or 'unnarrowed'} {', '.join(f'{v:.4f}' for v in fper[w])}"
                            for w in dict.fromkeys(turns))
                + f" ms (bound {fb[0]:.4f} ms by bytes, sector floor {ff:.4f} ms)")
            fmean = {w: sum(v) / len(v) for w, v in fper.items()}
            timings["fused_exchange_wire"] = dict(
                ms=fmean[BF16], bound=fb, library_ms=None,
                plain_ms=time_ms(lambda: fst.fused_exchange_plain(groups, spec, fplan, mesh, BF16),
                                 3),
                extra={"ms_unnarrowed": fmean[None], "ms_fp8": fmean[FP8]})
        del st, groups

    # DistributedDomain.exchange_loop at config 2 through each carrier, with
    # and without a wire; the B7 main path's launch (one, narrowed)
    for fused in (False, True):
        name = "fused_exchange" if fused else "remote_axis"
        line = []
        for wire in (None, BF16, FP8):
            dd = DistributedDomain(c2, c2, c2, device=dev)
            dd.set_radius(2)
            dd.set_methods(rdma_m)
            dd.set_devices([dev] * 8)
            dd.set_fused_exchange(fused)
            dd.set_wire_dtype(wire)
            hs = [dd.add_data(f"q{q}", "float32") for q in range(4)]
            dd.realize()
            st = wide_mesh(dd.spec, [f32] * 4, 650)
            for q, h in enumerate(hs):
                dd.set_curr(h, st[q])
            fn = fst.fused_exchange if fused else rdma.remote_axis
            fn.launches = fn.narrowed = 0
            dd.exchange_loop(1)(dd.curr_state())
            sync(dev)
            want_n = (1 if fused else 3) * (dev.type == "cuda")
            check(fn.launches == want_n and fn.narrowed == (want_n if wire else 0),
                  f"config-2 exchange via {name}, wire {wire}: {fn.launches} launches, "
                  f"{fn.narrowed} narrowed")
            if fused and wire == BF16:
                launches["fused_exchange_wire"] = fn.narrowed
            loop10 = dd.exchange_loop(10)
            ms = time_ms(lambda: loop10(dd.curr_state()), 3, warmup=1) / 10
            line.append(f"{wire or 'unnarrowed'} {ms:.4f}")
            del dd, st, loop10
        log(f"mesh exchange config 2 over 8 positions via {name} (exchange_loop, host included), "
            f"ms an exchange: {'; '.join(line)}")
    return timings, launches, errs, cpu_refs


def variant_wire_phase(dev, time_ms, cpu_refs, n: int = 512, steps: int = 8, iters: int = 50,
                       chunk: int = 25):
    """Phase 10's narrowed wire, on ``dev``: B8 with a wire against its plain
    version (bit patterns, NaN as one pattern, curr with its halos and nxt,
    every position) at ``n``^3 (2,2,2) r1 (random fields, bf16 and fp8) and
    24x20x16 (2,1,1) r1 (edge values, sel codes in [-1, 4), every wire);
    ``steps`` steps at ``n``^3 over 8 positions through the fused loop with
    bf16, fp8 e4m3fn, fp8 e5m2 and :data:`SOFT_TIMED` on the wire against
    phase 9's CPU loop (the fused and the plain mesh loops agree, on the CPU
    as on the card); the main path
    ``apps.jacobi3d.run(..., kernel_variant="fused", wire_dtype="bfloat16")``
    with launch counts reset around it (75 launches, all narrowed) beside
    the unnarrowed run in turns; B8 timed per launch at ``n``^3 over 8
    positions unnarrowed, bf16, fp8, fp8, bf16, unnarrowed. Returns
    ``(timings, launches, errs)``."""
    from stencil_tpu_torch import GridSpec
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.ops.jacobi import make_jacobi_loop, sphere_sel_blocks
    from stencil_tpu_torch.parallel import DeviceMesh, HaloExchange, Method, unshard_blocks
    from stencil_tpu_torch.plan.ir import build_plan
    from stencil_tpu_torch.utils.roofline import bound_ms

    f32 = torch.float32
    gen = torch.Generator(device=dev)
    rdma_m = Method.REMOTE_DMA
    errs = {"fused_jacobi_mesh_wire": 0.0}
    nan_patterns = 0

    def rspec(size, part, r):
        return GridSpec(Dim3(*size), Dim3(*part), Radius.constant(r))

    def fields(spec, seed, edges, codes):
        p = spec.padded()
        shape = (1, 1, 1, p.z, p.y, p.x)
        vals = torch.tensor(WIRE_EDGES, dtype=torch.float64, device=dev)
        gen.manual_seed(seed)
        out = []
        for _ in range(3 * spec.num_blocks()):
            if edges:
                out.append(vals[torch.randint(len(WIRE_EDGES), shape, generator=gen,
                                              device=dev)].to(f32))
            else:
                out.append(torch.rand(shape, generator=gen, device=dev))
        npos = spec.num_blocks()
        sels = [torch.randint(*codes, shape, generator=gen, device=dev, dtype=torch.int32)
                for _ in range(npos)]
        return out[:npos], out[npos:2 * npos], sels

    spec1 = rspec((n,) * 3, (2, 2, 2), 1)
    for i, (label, spec, edges, codes, wires) in enumerate((
            (f"{n}^3 (2,2,2) r1", spec1, False, (0, 3), (BF16, FP8)),
            ("24x20x16 (2,1,1) r1 edge values, sel in [-1, 4)", rspec((24, 20, 16), (2, 1, 1), 1),
             True, (-1, 4), (BF16, "float16", FP8)))):
        mesh = DeviceMesh(spec.dim, [dev] * spec.num_blocks())
        plan = build_plan(spec, spec.dim, rdma_m, fused=True)
        c, nx, s = fields(spec, 660 + 10 * i, edges, codes)
        for wire in wires:
            gc, gn = [b.clone() for b in c], [b.clone() for b in nx]
            pc, pn = [b.clone() for b in c], [b.clone() for b in nx]
            fst.fused_jacobi_mesh(gc, gn, s, spec, plan, mesh, wire)
            fst.fused_jacobi_mesh_plain(pc, pn, s, spec, plan, mesh, wire)
            res = [bits_equal(a, b) for a, b in zip(gc + gn, pc + pn)]
            nan_patterns += sum(k for _e, k in res)
            check(all(e for e, _k in res), f"fused_jacobi_mesh {label} {wire}: kernel != plain "
                  "(bit patterns, NaN as one pattern)")
            errs["fused_jacobi_mesh_wire"] = max(errs["fused_jacobi_mesh_wire"],
                                                 max(wire_err(a, b)
                                                     for a, b in zip(gc + gn, pc + pn)))
            del gc, gn, pc, pn
        log(f"fused_jacobi_mesh {label} through {', '.join(wires)}: equal (every position's curr "
            "with halos, and nxt; bit patterns)")
        del c, nx, s
    log(f"wire checks of phase 10: {nan_patterns} NaN cells whose widened bits differ between "
        "the card and the plain version (NaN as one pattern)")

    # steps through the fused loop with a wire against phase 9's CPU loop
    mesh8 = DeviceMesh((2, 2, 2), [dev] * 8)
    for wire in (BF16, FP8, E5M2, SOFT_TIMED):
        ex = HaloExchange(spec1, rdma_m, mesh=mesh8, fused=True, wire_dtype=wire)
        c = from_global(cpu_refs["field"], spec1, mesh8)
        out, _ = make_jacobi_loop(ex, steps)(c, [torch.zeros_like(b) for b in c],
                                             sphere_sel_blocks(spec1, mesh8))
        check(np.array_equal(unshard_blocks(out, spec1), cpu_refs[wire]),
              f"jacobi {n}^3 {steps} steps over 8 positions, fused loop with {wire} on the "
              "wire: card != the CPU's loop")
        log(f"jacobi {n}^3 {steps} steps over 8 positions, fused loop with {wire} on the wire: "
            "== the CPU's loop on every cell")
        del ex, c, out

    # the main path with bf16 on the wire, beside the unnarrowed run in turns
    launches, ms_iter = {}, {}
    for wire in (None, BF16, BF16, None):
        fst.fused_jacobi_mesh.launches = fst.fused_jacobi_mesh.narrowed = 0
        rv = jacobi3d.run(n, n, n, devices=[dev] * 8, method=rdma_m, iters=iters, chunk=chunk,
                          weak=False, kernel_variant="fused", wire_dtype=wire)
        sync(dev)
        got = (fst.fused_jacobi_mesh.launches, fst.fused_jacobi_mesh.narrowed)
        run_steps = (iters + chunk) * (dev.type == "cuda")
        check(got == (run_steps, run_steps if wire else 0),
              f"jacobi3d fused over 8 positions, wire {wire}: (launches, narrowed) {got}")
        fin = rv["domain"].get_curr_global(rv["handle"])
        check(bool(np.isfinite(fin).all()) and fin.min() >= 0.0 and fin.max() <= 1.0,
              f"jacobi3d fused over 8 positions, wire {wire}: field not finite or out of range")
        ms_iter.setdefault(wire, []).append(rv["iter_trimean_s"] * 1e3)
        log(f"jacobi3d {n}^3 over 8 positions of one card (remote-dma fused, wire {wire}): "
            f"{rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), {rv['mcells_per_s']:.1f} "
            f"Mcells/s, (launches, narrowed) {got}")
        if wire:
            launches["fused_jacobi_mesh_wire"] = got[1]
        del rv, fin
    log(f"jacobi3d fused {n}^3 over 8 positions, ms/iter in turns: unnarrowed "
        f"{', '.join(f'{v:.4f}' for v in ms_iter[None])}, bf16 on the wire "
        f"{', '.join(f'{v:.4f}' for v in ms_iter[BF16])}")

    # per launch in turns (cooperative launches: CUDA events, no graph)
    plan = build_plan(spec1, (2, 2, 2), rdma_m, fused=True)
    c, nx, s = fields(spec1, 690, False, (0, 3))
    turns = (None, BF16, FP8, FP8, BF16, None)
    per = {w: [] for w in turns}
    for wire in turns:
        per[wire].append(time_ms(
            lambda w=wire: fst.fused_jacobi_mesh(c, nx, s, spec1, plan, mesh8, w), 20))
    b = bound_ms(fst.fused_jacobi_mesh_bytes(plan, 8, spec1), 6 * n ** 3)
    log(f"time fused_jacobi_mesh {n}^3 over 8 positions per launch in turns: "
        + "; ".join(f"{w or 'unnarrowed'} {', '.join(f'{v:.4f}' for v in per[w])}"
                    for w in dict.fromkeys(turns))
        + f" ms (bound {b[0]:.4f} ms by {b[1]})")
    mean = {w: sum(v) / len(v) for w, v in per.items()}
    timings = {"fused_jacobi_mesh_wire": dict(
        ms=mean[BF16], bound=b, library_ms=None,
        plain_ms=time_ms(lambda: fst.fused_jacobi_mesh_plain(c, nx, s, spec1, plan, mesh8, BF16),
                         3, warmup=1),
        extra={"ms_unnarrowed": mean[None], "ms_fp8": mean[FP8]})}
    return timings, launches, errs


def format_edges():
    """The new formats' edge values, both signs: each format's largest
    value, its overflow tie and the tie's neighbours, twice the largest, its
    least normal (and just above), its least subnormal with a half, a
    quarter and ties around it, an exponent-only format's least value, the
    tie at 1 and fp64 values 2^-40 to either side of it (one rounding and
    two differ there), and 0, inf, NaN."""
    import math

    from stencil_tpu_torch.ops.halo_fill import WIRE_FORMATS

    vals = [0.0, math.inf, math.nan, 1.0, 1.5, 3.0, 3.3, 0.1]
    for name in NEW_WIRES:
        f = WIRE_FORMATS[name]
        e = math.floor(math.log2(f.top))
        tie = f.top + 2.0 ** (e - f.mant - 1)
        sub = 2.0 ** (f.emin - f.mant)
        half = 1 + 2.0 ** -(f.mant + 1)
        vals += [f.top, tie, math.nextafter(tie, 0.0), math.nextafter(tie, math.inf), 2 * f.top,
                 2.0 ** f.emin, 2.0 ** f.emin * (1 + 2.0 ** -20), 2.0 ** (f.emin - 1), sub,
                 sub / 2, sub / 4, 1.5 * sub, 2.5 * sub, half, half + 2.0 ** -40,
                 half - 2.0 ** -40]
    return [s * v for v in vals for s in (1.0, -1.0)]


class plain_carriers:
    """Within the block, B6's and B7's wrappers (with ``fill``, B4's too, as
    a mesh exchange calls it) run their plain versions on whatever tensors
    they are given (the card's included) and count nothing: the plain
    version of a path that calls them."""

    def __init__(self, fill: bool = False):
        self.fill = fill

    def __enter__(self):
        from stencil_tpu_torch.ops import fused_stencil as fst
        from stencil_tpu_torch.ops import halo_fill
        from stencil_tpu_torch.ops import remote_dma as rdma

        self.saved = (rdma.remote_axis, fst.fused_exchange, rdma.self_fill)
        rdma.remote_axis = lambda b, s, ph, m, w=None, local=None: \
            rdma.remote_axis_plain(b, s, ph, m, w, local)
        fst.fused_exchange = fst.fused_exchange_plain
        if self.fill:
            rdma.self_fill = lambda b, s, axis: halo_fill.self_fill_plain(b, s, axis)
        return self

    def __exit__(self, *exc):
        from stencil_tpu_torch.ops import fused_stencil as fst
        from stencil_tpu_torch.ops import remote_dma as rdma

        rdma.remote_axis, fst.fused_exchange, rdma.self_fill = self.saved
        return False


def copy_slabs(state, spec, mesh, phases):
    """The library yardstick of a mesh exchange's axis phases: B6's slabs
    (an axis of one position: its self-wrap) moved by Tensor.copy_, one
    call per slab and quantity."""
    from stencil_tpu_torch.ops import halo_fill

    for ph in phases:
        o, n, rm, rp = halo_fill.axis_geom(spec, ph.axis)
        for i, pos in enumerate(mesh.positions()):
            bwd, fwd = (mesh.index(q) for q in mesh.ring_neighbors(pos, ph.axis))
            for blocks in state.values():
                src = blocks[i]
                if rm:
                    dst = blocks[fwd]
                    dst[halo_fill._axis_slice(dst, ph.axis, o - rm, o)].copy_(
                        src[halo_fill._axis_slice(src, ph.axis, o + n - rm, o + n)])
                if rp:
                    dst = blocks[bwd]
                    dst[halo_fill._axis_slice(dst, ph.axis, o + n, o + n + rp)].copy_(
                        src[halo_fill._axis_slice(src, ph.axis, o, o + rp)])


def copy_boxes(state, mesh, plan):
    """The library yardstick of a fused mesh exchange: B7's messages moved by
    Tensor.copy_, one call per message and quantity."""
    from stencil_tpu_torch.ops import fused_stencil as fst

    for ph in plan.fused_phases:
        s_, d_ = fst.box_slices(ph.src, ph.dst, ph.shape)
        for i, pos in enumerate(mesh.positions()):
            j = mesh.index(mesh.shifted(pos, ph.direction))
            for blocks in state.values():
                blocks[j][d_].copy_(blocks[i][s_])


def mesh_formats_phase(dev, time_ms, n: int = 512, c2: int = 256, over: int = 256,
                       mixed: int = 128, ast: int = 128, small: int = 32, iters: int = 50,
                       chunk: int = 25):
    """Phase 9's every-format wire, on ``dev``: B6 (every ring phase) and B7
    through each of :data:`NEW_WIRES` against their plain versions by bit
    pattern on every cell of every position (NaN as one pattern), on fields
    of :func:`format_edges` at ``small``^3 (2,2,2) r2 fp32 and 40x36x20
    (1,2,2) r1 fp64 and on random fields of a 64^3 (2,2,2) r1 fp32 + fp64 +
    int32 dict (int32 copied bitwise), and each case's whole mesh exchange,
    plain and fused, on the card against the CPU; the wire on an
    oversubscribed mesh: (4,2,2) blocks of ``over``^3 on (2,2,2) positions
    in fp32 (bf16, e3m4) and fp64 (fp32, e5m2) and (2,2,2) blocks of
    ``mixed``^3 on (1,2,2) positions (x's ring of one: its shifts stay bit
    copies), one exchange each against its plain version by bit pattern on
    every cell, launches held (3 an exchange; every one narrowed on (2,2,2)
    positions, 2 on (1,2,2)); one Astaroth step and one fused-loop iteration over
    (2,2,2) x ``ast``^3 fp64 with an fp32 wire, each against the same run
    with the carriers' plain versions (torch.equal on every field), launches
    held; B6 per phase and B7 at config 2 (``c2``^3 (2,2,2) r2 x4 fp32)
    through e5m2 and :data:`SOFT_TIMED` against their plain versions by bit
    pattern, then they and the oversubscribed exchange timed per launch
    unnarrowed, e5m2,
    :data:`SOFT_TIMED`, :data:`SOFT_TIMED`, e5m2, unnarrowed; exchange_loop
    at config 2 through each carrier with e5m2 and the software format
    (its launch counts); the main paths ``apps.jacobi3d.run(n, n, n,
    devices=[dev] * 8, method=REMOTE_DMA)`` through e5m2 and the software
    format, and over (4,2,2) blocks on the 8 positions through e5m2, launch
    counts reset around each (3 remote_axis launches a step, every one
    narrowed). Sizes are arguments so that the phase can be rehearsed on
    the CPU. Returns ``(timings, launches, errs)``."""
    from stencil_tpu_torch import DistributedDomain, GridSpec
    from stencil_tpu_torch.apps import astaroth as astaroth_app
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.astaroth.integrate import (FIELDS, make_astaroth_step,
                                                      make_fused_astaroth_loop)
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.ops import remote_dma as rdma
    from stencil_tpu_torch.ops import stencil_kernels as sk
    from stencil_tpu_torch.parallel import DeviceMesh, HaloExchange, Method, split_positions
    from stencil_tpu_torch.plan.ir import build_plan
    from stencil_tpu_torch.utils.roofline import bound_ms

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev)
    rdma_m = Method.REMOTE_DMA
    names = ("remote_axis_wire_e5m2", "remote_axis_wire_soft", "fused_exchange_wire_e5m2",
             "fused_exchange_wire_soft", "remote_axis_wire_oversubscribed")
    errs = {name: 0.0 for name in names}
    timings, launches = {}, {}
    nan_patterns = 0
    edges = torch.tensor(format_edges(), dtype=f64, device=dev)

    def rspec(size, part, r):
        return GridSpec(Dim3(*size), Dim3(*part), Radius.constant(r))

    def fields(spec, dtypes, seed, edged=False, mesh=None):
        """{q: [stack per position of ``mesh``]} (one block a position
        without one): edge values or random sign and magnitude 2^U(-12, 9)
        in every cell; an int32 quantity random integers."""
        p = spec.padded()
        shape = tuple(spec.stacked_shape_zyx())
        out = {}
        for q, dt in enumerate(dtypes):
            gen.manual_seed(seed + q)
            if dt == i32:
                g = torch.randint(-2 ** 30, 2 ** 30, shape, generator=gen, device=dev, dtype=i32)
            elif edged:
                g = edges[torch.randint(len(edges), shape, generator=gen, device=dev)].to(dt)
            else:
                g = (torch.randn(shape, generator=gen, device=dev, dtype=f64) * torch.exp2(
                    torch.rand(shape, generator=gen, device=dev, dtype=f64) * 21 - 12)).to(dt)
            if mesh is None:
                out[q] = [b.view(1, 1, 1, p.z, p.y, p.x).clone()
                          for b in g.view(-1, p.z, p.y, p.x).unbind(0)]
            else:
                out[q] = split_positions(g, spec, mesh)
            del g
        return out

    def cloned(groups):
        return [[b.clone() for b in g] for g in groups]

    def held(name, label, got, want):
        nonlocal nan_patterns
        res = [bits_equal(a, b) for ga, gb in zip(got, want) for a, b in zip(ga, gb)]
        nan_patterns += sum(k for _e, k in res)
        check(all(e for e, _k in res), f"{name} {label}: kernel != plain (bit patterns, NaN as "
              "one pattern)")
        errs[name] = max(errs[name], max(wire_err(a, b) for ga, gb in zip(got, want)
                                         for a, b in zip(ga, gb)))

    def key_of(wire):
        return "e5m2" if wire == E5M2 else "soft"

    # -- every new format through B6 and B7, kernel against plain -------------------
    for i, (label, spec, dts, edged) in enumerate((
            (f"edge values {small}^3 (2,2,2) r2 fp32", rspec((small,) * 3, (2, 2, 2), 2), [f32],
             True),
            ("edge values 40x36x20 (1,2,2) r1 fp64", rspec((40, 36, 20), (1, 2, 2), 1), [f64],
             True),
            ("64^3 (2,2,2) r1 fp32 + fp64 + int32", rspec((64,) * 3, (2, 2, 2), 1),
             [f32, f64, i32], False))):
        mesh = DeviceMesh(spec.dim, [dev] * spec.num_blocks())
        cpu_mesh = DeviceMesh(spec.dim, [cpu] * spec.num_blocks())
        st = fields(spec, dts, 700 + 10 * i, edged)
        plan = build_plan(spec, spec.dim, rdma_m)
        fplan = build_plan(spec, spec.dim, rdma_m, fused=True)
        for wire in NEW_WIRES:
            for dt in dict.fromkeys(dts):
                start = [[st[k][j] for k, d in enumerate(dts) if d == dt]
                         for j in range(spec.num_blocks())]
                for ph in plan.remote_phases:
                    if ph.ring > 1 and ph.active:
                        got = rdma.remote_axis(cloned(start), spec, ph, mesh, wire)
                        want = rdma.remote_axis_plain(cloned(start), spec, ph, mesh, wire)
                        held(f"remote_axis_wire_{key_of(wire)}", f"{label} {dt} {ph.axis} {wire}",
                             got, want)
                got = fst.fused_exchange(cloned(start), spec, fplan, mesh, wire)
                want = fst.fused_exchange_plain(cloned(start), spec, fplan, mesh, wire)
                held(f"fused_exchange_wire_{key_of(wire)}", f"{label} {dt} {wire}", got, want)
            for fused in (False, True):
                card = {q: [b.clone() for b in bl] for q, bl in st.items()}
                host = {q: [b.cpu() for b in bl] for q, bl in st.items()}
                HaloExchange(spec, rdma_m, mesh=mesh, fused=fused, wire_dtype=wire)(card)
                HaloExchange(spec, rdma_m, mesh=cpu_mesh, fused=fused, wire_dtype=wire)(host)
                for q in st:
                    check(all(bits_equal(a.cpu(), b)[0] for a, b in zip(card[q], host[q])),
                          f"mesh exchange {label} fused={fused} {wire} q{q}: card != CPU")
                del card, host
        log(f"mesh {label} through each of {', '.join(NEW_WIRES)}: remote_axis and "
            "fused_exchange == plain (bit patterns, every cell); both exchanges on the card == "
            "the CPU")
        del st
    log(f"every-format wire checks: {nan_patterns} NaN cells whose widened bits differ between "
        "the card and the plain version (NaN as one pattern)")

    # -- the wire on an oversubscribed mesh: only the slabs between positions round ----
    def oversubscribed(label, size, part, mesh_dim, dt, wires, narrowed, timed=False):
        spec = rspec(size, part, 1)
        mesh = DeviceMesh(Dim3(*mesh_dim), [dev] * Dim3(*mesh_dim).flatten())
        st = fields(spec, [dt], 760, mesh=mesh)
        per = {}
        for wire in wires:
            ex = HaloExchange(spec, rdma_m, mesh=mesh, wire_dtype=wire)
            card = {0: [b.clone() for b in st[0]]}
            plain = {0: [b.clone() for b in st[0]]}
            rdma.remote_axis.launches = rdma.remote_axis.narrowed = 0
            ex(card)
            sync(dev)
            got = (rdma.remote_axis.launches, rdma.remote_axis.narrowed)
            check(got == (3 * on_card, narrowed * on_card),
                  f"oversubscribed {label} {wire}: (launches, narrowed) {got}, expected "
                  f"{(3 * on_card, narrowed * on_card)}")
            with plain_carriers():
                ex(plain)
            res = [bits_equal(a, b) for a, b in zip(card[0], plain[0])]
            check(all(e for e, _k in res), f"oversubscribed {label} {wire}: kernel != plain")
            errs["remote_axis_wire_oversubscribed"] = max(
                errs["remote_axis_wire_oversubscribed"],
                max(wire_err(a, b) for a, b in zip(card[0], plain[0])))
            del card, plain
            log(f"oversubscribed mesh {label} {dt} through {wire}: (launches, narrowed) {got}, "
                "every cell of every block == the plain version (bit patterns)")
        if timed:
            ex_of = {w: HaloExchange(spec, rdma_m, mesh=mesh, wire_dtype=w)
                     for w in (None, E5M2, SOFT_TIMED)}
            ex_of[None](st)
            for w in (None, E5M2, SOFT_TIMED, SOFT_TIMED, E5M2, None):
                per.setdefault(w, []).append(time_ms(lambda w=w: ex_of[w](st), 10, graph=True)
                                             / 3)
            with plain_carriers():
                plain = time_ms(lambda: ex_of[E5M2](st), 3) / 3
            ring = [ph for ph in build_plan(spec, spec.dim, rdma_m).remote_phases if ph.active]
            nbytes = sum(rdma.remote_axis_bytes(spec, ph, 1, spec.num_blocks(), dt.itemsize)
                         for ph in ring) / len(ring)
            timings["remote_axis_wire_oversubscribed"] = dict(
                ms=sum(per[E5M2]) / len(per[E5M2]), plain_ms=plain, bound=bound_ms(nbytes, 0),
                library_ms=None, extra={"ms_unnarrowed": sum(per[None]) / len(per[None]),
                                        "ms_soft": sum(per[SOFT_TIMED]) / len(per[SOFT_TIMED])})
            log(f"time oversubscribed {label} exchange (CUDA-graph replay), per launch (mean "
                "of its 3) in turns: "
                + "; ".join(f"{w or 'unnarrowed'} {', '.join(f'{v:.4f}' for v in per[w])}"
                            for w in dict.fromkeys(per))
                + f" ms (bound {bound_ms(nbytes, 0)[0]:.4f} ms by bytes)")
        del st

    oversubscribed(f"(4,2,2) x {over}^3 on (2,2,2) positions", (4 * over, 2 * over, 2 * over),
                   (4, 2, 2), (2, 2, 2), f32, (BF16, "float8_e3m4"), 3, timed=True)
    oversubscribed(f"(4,2,2) x {over}^3 on (2,2,2) positions", (4 * over, 2 * over, 2 * over),
                   (4, 2, 2), (2, 2, 2), f64, ("float32", E5M2), 3)
    oversubscribed(f"(2,2,2) x {mixed}^3 on (1,2,2) positions", (2 * mixed,) * 3, (2, 2, 2),
                   (1, 2, 2), f32, (E5M2,), 2)
    log(f"every-format wire phase: oversubscribed done at {time.perf_counter() - t0:.1f} s")

    # -- the Astaroth mesh with an fp32 wire: one step, one fused-loop iteration --------
    ainfo = astaroth_app.load()
    spec = rspec((2 * ast,) * 3, (2, 2, 2), 3)
    mesh = DeviceMesh((2, 2, 2), [dev] * 8)
    gen.manual_seed(780)
    g = {k: torch.rand(tuple(spec.stacked_shape_zyx()), generator=gen, device=dev,
                       dtype=f64) for k in FIELDS}
    for fused in (False, True):
        outs = []
        for plain in (False, True):
            fn = fst.fused_exchange if fused else rdma.remote_axis
            fn.launches = fn.narrowed = 0
            ex = HaloExchange(spec, rdma_m, mesh=mesh, fused=fused, wire_dtype="float32")
            curr = {k: split_positions(t, spec, mesh) for k, t in g.items()}
            nxt = {k: [torch.zeros_like(b) for b in v] for k, v in curr.items()}
            step = (make_fused_astaroth_loop(ex, ainfo, iters=1, dt=1e-5, dtype="float64")
                    if fused else make_astaroth_step(ex, ainfo, dt=1e-5, iters=1, dtype="float64"))
            sync(dev)
            if plain:
                with plain_carriers():
                    curr, nxt = step(curr, nxt)
            else:
                curr, nxt = step(curr, nxt)
            sync(dev)
            counts = (fn.launches, fn.narrowed)
            want = (0, 0) if plain or not on_card else ((1, 1) if fused else (3, 3))
            check(counts == want, f"astaroth mesh {'fused loop' if fused else 'step'} with an "
                  f"fp32 wire: (launches, narrowed) {counts}, expected {want}")
            outs.append(curr)
            del ex, nxt, step
        check(all(torch.equal(a, b) for k in FIELDS for a, b in zip(outs[0][k], outs[1][k])),
              f"astaroth mesh {'fused loop' if fused else 'step'} (2,2,2) x {ast}^3 fp64 with an "
              "fp32 wire: card != the same run with the carriers' plain versions")
        log(f"astaroth mesh {'fused loop' if fused else 'step'} (2,2,2) x {ast}^3 fp64, fp32 on "
            f"the wire, one iteration: every field == the run with the carriers' plain versions "
            f"({'B7 once, narrowed' if fused else 'B6 3 launches, all narrowed'})")
        del outs
    del g

    # -- B6 per phase and B7 at config 2, in turns -----------------------------------
    spec = rspec((c2,) * 3, (2, 2, 2), 2)
    mesh = DeviceMesh((2, 2, 2), [dev] * 8)
    st = fields(spec, [f32] * 4, 790)
    groups = [[st[q][j] for q in range(4)] for j in range(8)]
    ring = [ph for ph in build_plan(spec, (2, 2, 2), rdma_m).remote_phases if ph.active]
    fplan = build_plan(spec, (2, 2, 2), rdma_m, fused=True)
    for wire in (E5M2, SOFT_TIMED):
        for ph in ring:
            held(f"remote_axis_wire_{key_of(wire)}", f"config 2 {ph.axis} {wire}",
                 rdma.remote_axis(cloned(groups), spec, ph, mesh, wire),
                 rdma.remote_axis_plain(cloned(groups), spec, ph, mesh, wire))
        held(f"fused_exchange_wire_{key_of(wire)}", f"config 2 {wire}",
             fst.fused_exchange(cloned(groups), spec, fplan, mesh, wire),
             fst.fused_exchange_plain(cloned(groups), spec, fplan, mesh, wire))
    log(f"config 2 ({c2}^3 (2,2,2) r2 x4 fp32) through {E5M2} and {SOFT_TIMED}: remote_axis "
        "(each phase) and fused_exchange == plain (bit patterns, every cell)")
    turns = (None, E5M2, SOFT_TIMED, SOFT_TIMED, E5M2, None)
    per = {w: [[] for _ in ring] for w in turns}
    fper = {w: [] for w in turns}
    for wire in turns:
        for k, ph in enumerate(ring):
            per[wire][k].append(time_ms(
                lambda ph=ph, w=wire: rdma.remote_axis(groups, spec, ph, mesh, w), 20, graph=True))
        fper[wire].append(time_ms(lambda w=wire: fst.fused_exchange(groups, spec, fplan, mesh, w),
                                  20, graph=True))
    for k, ph in enumerate(ring):
        log(f"time remote_axis config 2 {ph.axis} per launch in turns: "
            + "; ".join(f"{w or 'unnarrowed'} {', '.join(f'{v:.4f}' for v in per[w][k])}"
                        for w in dict.fromkeys(turns))
            + f" ms (bound {bound_ms(rdma.remote_axis_bytes(spec, ph, 4, 8, 4), 0)[0]:.4f} ms)")
    log("time fused_exchange config 2 per launch in turns: "
        + "; ".join(f"{w or 'unnarrowed'} {', '.join(f'{v:.4f}' for v in fper[w])}"
                    for w in dict.fromkeys(turns)) + " ms")
    mean = {w: sum(sum(v) / len(v) for v in per[w]) / len(ring) for w in per}
    fmean = {w: sum(v) / len(v) for w, v in fper.items()}
    nbytes = sum(rdma.remote_axis_bytes(spec, ph, 4, 8, 4) for ph in ring) / len(ring)
    fb = bound_ms(fst.fused_exchange_bytes(fplan, 4, 8, 4), 0)
    for wire in (E5M2, SOFT_TIMED):
        timings[f"remote_axis_wire_{key_of(wire)}"] = dict(
            ms=mean[wire], bound=bound_ms(nbytes, 0), library_ms=None,
            plain_ms=time_ms(lambda w=wire: [rdma.remote_axis_plain(groups, spec, ph, mesh, w)
                                             for ph in ring], 3) / len(ring),
            extra={"ms_unnarrowed": mean[None], "wire": wire})
        timings[f"fused_exchange_wire_{key_of(wire)}"] = dict(
            ms=fmean[wire], bound=fb, library_ms=None,
            plain_ms=time_ms(lambda w=wire: fst.fused_exchange_plain(groups, spec, fplan, mesh,
                                                                     w), 3),
            extra={"ms_unnarrowed": fmean[None], "wire": wire})
    del st, groups

    # -- exchange_loop at config 2 through each carrier: the B7 launches -------------
    for fused in (False, True):
        name = "fused_exchange" if fused else "remote_axis"
        fn = fst.fused_exchange if fused else rdma.remote_axis
        for wire in (E5M2, SOFT_TIMED):
            dd = DistributedDomain(c2, c2, c2, device=dev)
            dd.set_radius(2)
            dd.set_methods(rdma_m)
            dd.set_devices([dev] * 8)
            dd.set_fused_exchange(fused)
            dd.set_wire_dtype(wire)
            hs = [dd.add_data(f"q{q}", "float32") for q in range(4)]
            dd.realize()
            st = fields(dd.spec, [f32] * 4, 795)
            for q, h in enumerate(hs):
                dd.set_curr(h, st[q])
            fn.launches = fn.narrowed = 0
            dd.exchange_loop(1)(dd.curr_state())
            sync(dev)
            want_n = (1 if fused else 3) * on_card
            check(fn.launches == want_n and fn.narrowed == want_n,
                  f"config-2 exchange via {name}, wire {wire}: {fn.launches} launches, "
                  f"{fn.narrowed} narrowed")
            if fused:
                launches[f"fused_exchange_wire_{key_of(wire)}"] = fn.narrowed
            del dd, st

    # -- the main paths: jacobi3d over 8 positions through e5m2 and the software ----
    #    format, and over (4,2,2) blocks on the 8 positions through e5m2
    run_steps = (iters + chunk) * on_card
    hot, cold = (m.cpu() for m in sk.sphere_masks_from_coords(rspec((n,) * 3, (1, 1, 1), 1), dev))
    for key, wire, kw in (("e5m2", E5M2, {}), ("soft", SOFT_TIMED, {}),
                          ("oversubscribed", E5M2, {"partition": (4, 2, 2)})):
        rdma.remote_axis.launches = rdma.remote_axis.narrowed = 0
        rv = jacobi3d.run(n, n, n, devices=[dev] * 8, method=rdma_m, iters=iters, chunk=chunk,
                          weak=False, wire_dtype=wire, **kw)
        sync(dev)
        got = (rdma.remote_axis.launches, rdma.remote_axis.narrowed)
        m = rv["domain"].mesh.dim  # an axis whose positions' ring is 1 narrows nothing
        want = (3 * run_steps, sum(k > 1 for k in (m.x, m.y, m.z)) * run_steps)
        check(got == want, f"jacobi3d over 8 positions {kw} (mesh {m}), wire {wire}: "
              f"remote_axis (launches, narrowed) {got}, expected {want}")
        fin = torch.from_numpy(rv["domain"].get_curr_global(rv["handle"]))
        check(bool(torch.isfinite(fin).all()) and float(fin.min()) >= 0.0
              and float(fin.max()) <= 1.0 and bool((fin[hot] == 1.0).all())
              and bool((fin[cold] == 0.0).all()),
              f"jacobi3d over 8 positions {kw}, wire {wire}: field not finite, out of range or "
              "spheres lost")
        launches[f"remote_axis_wire_{key}"] = got[1]
        log(f"jacobi3d {n}^3 over 8 positions {kw} (mesh {m}; remote-dma, wire {wire}): "
            f"{rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), remote_axis (launches, "
            f"narrowed) {got}")
        del rv, fin
    log(f"every-format wire phase (9): {time.perf_counter() - t0:.1f} s")
    return timings, launches, errs


def variant_formats_phase(dev, time_ms, n: int = 512, iters: int = 50, chunk: int = 25):
    """Phase 10's every-format wire, on ``dev``: B8 through each of
    :data:`NEW_WIRES` against its plain version by bit pattern (NaN as one
    pattern; curr with its halos and nxt, every position) at 24x20x16
    (2,1,1) r1 of :func:`format_edges` with sel codes in [-1, 4), and
    through e5m2 and :data:`SOFT_TIMED` at ``n``^3 (2,2,2) r1 from random
    fields; the main path ``apps.jacobi3d.run(..., kernel_variant="fused")``
    over 8 positions through each of the two (75 launches, all narrowed);
    B8 timed per launch at ``n``^3 over 8 positions unnarrowed, e5m2, the
    software format, the software format, e5m2, unnarrowed. Returns
    ``(timings, launches, errs)``."""
    from stencil_tpu_torch import GridSpec
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.parallel import DeviceMesh, Method
    from stencil_tpu_torch.plan.ir import build_plan
    from stencil_tpu_torch.utils.roofline import bound_ms

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    f32 = torch.float32
    gen = torch.Generator(device=dev)
    rdma_m = Method.REMOTE_DMA
    names = ("fused_jacobi_mesh_wire_e5m2", "fused_jacobi_mesh_wire_soft")
    errs = {name: 0.0 for name in names}
    edges = torch.tensor(format_edges(), dtype=torch.float64, device=dev)
    nan_patterns = 0

    def fields(spec, seed, edged, codes):
        p = spec.padded()
        shape = (1, 1, 1, p.z, p.y, p.x)
        gen.manual_seed(seed)
        npos = spec.num_blocks()
        out = [edges[torch.randint(len(edges), shape, generator=gen, device=dev)].to(f32)
               if edged else torch.rand(shape, generator=gen, device=dev)
               for _ in range(2 * npos)]
        sels = [torch.randint(*codes, shape, generator=gen, device=dev, dtype=torch.int32)
                for _ in range(npos)]
        return out[:npos], out[npos:], sels

    spec1 = GridSpec(Dim3(n, n, n), Dim3(2, 2, 2), Radius.constant(1))
    mesh8 = DeviceMesh((2, 2, 2), [dev] * 8)
    for i, (label, spec, edged, codes, wires) in enumerate((
            ("24x20x16 (2,1,1) r1 edge values, sel in [-1, 4)",
             GridSpec(Dim3(24, 20, 16), Dim3(2, 1, 1), Radius.constant(1)), True, (-1, 4),
             NEW_WIRES),
            (f"{n}^3 (2,2,2) r1", spec1, False, (0, 3), (E5M2, SOFT_TIMED)))):
        mesh = DeviceMesh(spec.dim, [dev] * spec.num_blocks())
        plan = build_plan(spec, spec.dim, rdma_m, fused=True)
        c, nx, s = fields(spec, 800 + 10 * i, edged, codes)
        for wire in wires:
            gc, gn = [b.clone() for b in c], [b.clone() for b in nx]
            pc, pn = [b.clone() for b in c], [b.clone() for b in nx]
            fst.fused_jacobi_mesh(gc, gn, s, spec, plan, mesh, wire)
            fst.fused_jacobi_mesh_plain(pc, pn, s, spec, plan, mesh, wire)
            res = [bits_equal(a, b) for a, b in zip(gc + gn, pc + pn)]
            nan_patterns += sum(k for _e, k in res)
            check(all(e for e, _k in res), f"fused_jacobi_mesh {label} {wire}: kernel != plain "
                  "(bit patterns, NaN as one pattern)")
            key = names[0] if wire == E5M2 else names[1]
            errs[key] = max(errs[key], max(wire_err(a, b) for a, b in zip(gc + gn, pc + pn)))
            del gc, gn, pc, pn
        log(f"fused_jacobi_mesh {label} through each of {', '.join(wires)}: equal (every "
            "position's curr with halos, and nxt; bit patterns)")
        del c, nx, s
    log(f"every-format wire checks of phase 10: {nan_patterns} NaN cells whose widened bits "
        "differ between the card and the plain version (NaN as one pattern)")

    # the main paths through e5m2 and the software format
    launches = {}
    run_steps = (iters + chunk) * on_card
    for key, wire in zip(names, (E5M2, SOFT_TIMED)):
        fst.fused_jacobi_mesh.launches = fst.fused_jacobi_mesh.narrowed = 0
        rv = jacobi3d.run(n, n, n, devices=[dev] * 8, method=rdma_m, iters=iters, chunk=chunk,
                          weak=False, kernel_variant="fused", wire_dtype=wire)
        sync(dev)
        got = (fst.fused_jacobi_mesh.launches, fst.fused_jacobi_mesh.narrowed)
        check(got == (run_steps, run_steps),
              f"jacobi3d fused over 8 positions, wire {wire}: (launches, narrowed) {got}")
        fin = rv["domain"].get_curr_global(rv["handle"])
        check(bool(np.isfinite(fin).all()) and fin.min() >= 0.0 and fin.max() <= 1.0,
              f"jacobi3d fused over 8 positions, wire {wire}: field not finite or out of range")
        launches[key] = got[1]
        log(f"jacobi3d {n}^3 over 8 positions (remote-dma fused, wire {wire}): "
            f"{rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), (launches, narrowed) {got}")
        del rv, fin

    # per launch in turns (cooperative launches: CUDA events, no graph)
    plan = build_plan(spec1, (2, 2, 2), rdma_m, fused=True)
    c, nx, s = fields(spec1, 890, False, (0, 3))
    turns = (None, E5M2, SOFT_TIMED, SOFT_TIMED, E5M2, None)
    per = {w: [] for w in turns}
    for wire in turns:
        per[wire].append(time_ms(
            lambda w=wire: fst.fused_jacobi_mesh(c, nx, s, spec1, plan, mesh8, w), 20))
    b = bound_ms(fst.fused_jacobi_mesh_bytes(plan, 8, spec1), 6 * n ** 3)
    log(f"time fused_jacobi_mesh {n}^3 over 8 positions per launch in turns: "
        + "; ".join(f"{w or 'unnarrowed'} {', '.join(f'{v:.4f}' for v in per[w])}"
                    for w in dict.fromkeys(turns))
        + f" ms (bound {b[0]:.4f} ms by {b[1]})")
    timings = {}
    for key, wire in zip(names, (E5M2, SOFT_TIMED)):
        timings[key] = dict(
            ms=sum(per[wire]) / len(per[wire]), bound=b, library_ms=None,
            plain_ms=time_ms(lambda w=wire: fst.fused_jacobi_mesh_plain(c, nx, s, spec1, plan,
                                                                        mesh8, w), 3, warmup=1),
            extra={"ms_unnarrowed": sum(per[None]) / len(per[None]), "wire": wire})
    del c, nx, s
    log(f"every-format wire phase (10): {time.perf_counter() - t0:.1f} s")
    return timings, launches, errs


def uneven_phase(dev, time_ms, n: int = 512, small=(67, 45, 29), asym=(100, 70, 61),
                 iters: int = 10, chunk: int = 5, steps: int = 8, gn: int = 128,
                 c2_gbs=None):
    """Phase 12, uneven (remainder) partitions, on ``dev``: B6's uneven ring
    (remote_axis over a ring whose blocks differ in size) against its plain
    version with torch.equal on every cell of every position, from random
    fields with noise in every halo, at ``n``^3 over 6 positions (3,2,1) r1,
    ``small`` (3,2,1) unaligned, ``asym`` (2,3,1) with face radii x 2/1,
    y 1/2, z 1/1 and 512x64x32 over 5 positions (5,1,1), in fp32 and
    fp64, unnarrowed and through bf16 (fp64 also through fp32; bit patterns,
    NaN as one pattern); each phase timed per launch at ``n``^3 (3,2,1) r1
    beside its bytes bound and sector floor, with the uniform x phases of
    ``n + 1`` x ``n`` x ``n`` (3,2,1) (the same padded pitch; also in
    turns with the uneven one) and ``n``^3 (2,2,2) in the same call; the
    resident uneven exchange (``n``^3 (3,2,1) r3 x4 fp32 and 13x11x9
    (2,2,2) r2 fp64) on the card against the same
    exchange on the CPU, every cell, with its fill launches, and in GB/s
    beside ``c2_gbs``; ``steps`` steps from a random field over 6 positions
    (plain and fused) and over (3,2,1) residents, bit-equal on the gathered
    compute region to the single-block default path; the main paths
    ``apps.jacobi3d.run`` at ``n``^3 strong over 6 positions (plain and
    fused: ``iters`` steps in chunks of ``chunk`` after a warm-up chunk) and
    over (3,2,1) residents, launch counts reset just before and read just
    after, held to the counts per step; a guarded jacobi3d at ``gn``^3 over
    6 positions with nan@3 rolled back, equal to the clean run; a
    checkpoint written on (3,2,1) and restored on (2,2,2), equal on the
    compute region; and each launch of the two uneven steps timed alone
    (the per-position sweeps, the z fill, one position's shells; the
    stacked sweep and the resident exchange). Sizes are arguments so that
    the phase can be rehearsed on the CPU. Returns ``(timings, launches,
    errs)``."""
    from stencil_tpu_torch import DistributedDomain, GridSpec
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.geometry import Dim3, Radius, Rect3
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.ops import halo_fill
    from stencil_tpu_torch.ops import remote_dma as rdma
    from stencil_tpu_torch.ops import shells
    from stencil_tpu_torch.ops import stencil_kernels as sk
    from stencil_tpu_torch.ops.jacobi import make_jacobi_loop, sphere_sel_blocks
    from stencil_tpu_torch.parallel import (DeviceMesh, HaloExchange, Method, shard_blocks,
                                            unshard_blocks)
    from stencil_tpu_torch.plan.ir import build_plan
    from stencil_tpu_torch.utils.roofline import bound_ms

    f32, f64 = torch.float32, torch.float64
    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev)
    rd = Method.REMOTE_DMA

    def spec_of(size, part, r, aligned=True):
        if isinstance(r, int):
            rad = Radius.constant(r)
        else:
            rad = Radius.constant(0)
            for d, v in zip(((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
                             (0, 0, 1)), r):
                rad.set_dir(d, v)
            rad.set_edge(1)
            rad.set_corner(1)
        return GridSpec(Dim3(*size), Dim3(*part), rad, aligned=aligned)

    def mesh_of(spec, device=dev):
        return DeviceMesh(spec.dim, [device] * spec.dim.flatten())

    def rand_groups(spec, dtype, nq, seed):
        """[[block per quantity] per position]: noise in every cell."""
        gen.manual_seed(seed)
        p = spec.padded()
        return [[torch.rand((1, 1, 1, p.z, p.y, p.x), generator=gen, device=dev,
                            dtype=f64).to(dtype) for _ in range(nq)]
                for _ in range(spec.num_blocks())]

    def cloned(groups):
        return [[b.clone() for b in g] for g in groups]

    def rings(spec):
        return [ph for ph in build_plan(spec, spec.dim, rd).remote_phases
                if ph.ring > 1 and ph.active]

    errs = {"remote_axis_uneven": 0.0}
    nan_patterns = 0
    on_card = dev.type == "cuda"  # the plain versions (a CPU rehearsal) count no launch

    # -- B6's uneven ring against its plain version ----------------------------
    spec6 = spec_of((n,) * 3, (3, 2, 1), 1)
    cases = [(f"{n}^3 (3,2,1) r1", spec6, 1),
             ("x".join(map(str, small)) + " (3,2,1) unaligned",
              spec_of(small, (3, 2, 1), 1, aligned=False), 2),
             ("x".join(map(str, asym)) + " (2,3,1) x 2/1 y 1/2 z 1/1",
              spec_of(asym, (2, 3, 1), (2, 1, 1, 2, 1, 1)), 2),
             ("512x64x32 (5,1,1)", spec_of((512, 64, 32), (5, 1, 1), 1), 1)]
    for i, (label, spec, nq) in enumerate(cases):
        check(not spec.is_uniform(), f"{label}: not an uneven partition")
        mesh = mesh_of(spec)
        for dt, wires in ((f32, (None, "bfloat16")), (f64, (None, "bfloat16", "float32"))):
            start = rand_groups(spec, dt, nq, 1200 + 10 * i)
            for ph in rings(spec):
                for wire in wires:
                    got = rdma.remote_axis(cloned(start), spec, ph, mesh, wire)
                    want = rdma.remote_axis_plain(cloned(start), spec, ph, mesh, wire)
                    sync(dev)
                    if wire is None:
                        errs["remote_axis_uneven"] = max(
                            errs["remote_axis_uneven"],
                            max(max_abs(a, b) for ga, gb in zip(got, want)
                                for a, b in zip(ga, gb)))
                        ok = all(torch.equal(a, b) for ga, gb in zip(got, want)
                                 for a, b in zip(ga, gb))
                    else:
                        res = [bits_equal(a, b) for ga, gb in zip(got, want)
                               for a, b in zip(ga, gb)]
                        nan_patterns += sum(k for _e, k in res)
                        ok = all(e for e, _k in res)
                    check(ok, f"remote_axis uneven {label} {dt} {ph.axis} wire {wire}: "
                              "kernel != plain")
            del start
        log(f"remote_axis uneven ring {label} (sizes x {spec.sizes_x}, y {spec.sizes_y}): "
            "== plain on every cell of every position, fp32 and fp64, unnarrowed and through "
            f"bf16 (fp64 also fp32) by bit pattern ({nan_patterns} NaN patterns differ)")

    # each phase timed at n^3 (3,2,1) r1 x1, beside the uniform x phases of
    # (n+1) x n x n (3,2,1) (the same padded pitch) and n^3 (2,2,2)
    def copy_slabs(groups, spec, ph, mesh):
        """The library yardstick: the phase's slabs moved by Tensor.copy_, one
        call per slab."""
        o, _base, rm, rp = halo_fill.axis_geom(spec, ph.axis)
        sizes = rdma.ring_sizes(spec, ph.axis, mesh)
        for j, pos in enumerate(mesh.positions()):
            bwd, fwd = (mesh.index(q) for q in mesh.ring_neighbors(pos, ph.axis))
            for src, dfw, dbw in zip(groups[j], groups[fwd], groups[bwd]):
                if rm:
                    dfw[halo_fill._axis_slice(dfw, ph.axis, o - rm, o)].copy_(
                        src[halo_fill._axis_slice(src, ph.axis, o + sizes[j] - rm,
                                                  o + sizes[j])])
                if rp:
                    dbw[halo_fill._axis_slice(dbw, ph.axis, o + sizes[bwd],
                                              o + sizes[bwd] + rp)].copy_(
                        src[halo_fill._axis_slice(src, ph.axis, o, o + rp)])

    mesh6 = mesh_of(spec6)
    groups6 = rand_groups(spec6, f32, 1, 1300)
    per = []
    for ph in rings(spec6):
        ms = time_ms(lambda ph=ph: rdma.remote_axis(groups6, spec6, ph, mesh6), 20, graph=True)
        plain = time_ms(lambda ph=ph: rdma.remote_axis_plain(groups6, spec6, ph, mesh6), 3,
                        warmup=1)
        lib = time_ms(lambda ph=ph: copy_slabs(groups6, spec6, ph, mesh6), 5, graph=True)
        nbytes = rdma.remote_axis_bytes(spec6, ph, 1, 6, 4)
        sbytes = rdma.remote_axis_sector_bytes(spec6, ph, 1, 6, 4)
        per.append((ms, plain, lib, nbytes))
        log(f"time remote_axis uneven {n}^3 (3,2,1) r1 x1 {ph.axis}: {ms:.4f} ms per launch "
            f"(plain {plain:.4f} ms, Tensor.copy_ {lib:.4f} ms, bound "
            f"{bound_ms(nbytes, 0)[0]:.4f} ms by bytes, sector floor "
            f"{bound_ms(sbytes, 0)[0]:.4f} ms)")
    for label, uspec in ((f"{n + 1}x{n}x{n} (3,2,1) r1 (uniform, the same padded pitch)",
                          spec_of((n + 1, n, n), (3, 2, 1), 1)),
                         (f"{n}^3 (2,2,2) r1 (uniform)", spec_of((n,) * 3, (2, 2, 2), 1))):
        check(uspec.is_uniform(), f"{label}: not uniform")
        umesh = mesh_of(uspec)
        ug = rand_groups(uspec, f32, 1, 1310)
        (xph,) = [ph for ph in rings(uspec) if ph.axis == "x"]
        ms = time_ms(lambda: rdma.remote_axis(ug, uspec, xph, umesh), 20, graph=True)
        log(f"time remote_axis {label} x: {ms:.4f} ms per launch (bound "
            f"{bound_ms(rdma.remote_axis_bytes(uspec, xph, 1, len(umesh), 4), 0)[0]:.4f} ms by "
            f"bytes, sector floor "
            f"{bound_ms(rdma.remote_axis_sector_bytes(uspec, xph, 1, len(umesh), 4), 0)[0]:.4f}"
            f" ms; padded {tuple(uspec.padded())} against the uneven "
            f"{tuple(spec6.padded())})")
        if uspec.padded() == spec6.padded():
            # the uneven and the uniform x phase at one pitch, in turns
            (x6,) = [ph for ph in rings(spec6) if ph.axis == "x"]
            turns = {"uneven": [], "uniform": []}
            for turn in ("uneven", "uniform", "uniform", "uneven") * 2:
                g_, s_, m_, ph_ = ((groups6, spec6, mesh6, x6) if turn == "uneven"
                                   else (ug, uspec, umesh, xph))
                turns[turn].append(time_ms(lambda: rdma.remote_axis(g_, s_, ph_, m_), 20,
                                           graph=True))
            log("time remote_axis x phase at one padded pitch, in turns (uneven, uniform, "
                "uniform, uneven, twice): uneven "
                + ", ".join(f"{v:.4f}" for v in turns["uneven"]) + " ms; uniform "
                + ", ".join(f"{v:.4f}" for v in turns["uniform"]) + " ms")
        del ug
    del groups6
    k = len(per)
    timings = {"remote_axis_uneven": dict(
        ms=sum(p[0] for p in per) / k, plain_ms=sum(p[1] for p in per) / k,
        bound=bound_ms(sum(p[3] for p in per) / k, 0), library_ms=sum(p[2] for p in per) / k)}

    # -- the resident uneven exchange, on the card against the CPU -------------
    for label, spec, nq, dt in ((f"{n}^3 (3,2,1) r3 x4 fp32", spec_of((n,) * 3, (3, 2, 1), 3), 4,
                                 f32),
                                ("13x11x9 (2,2,2) r2 fp64", spec_of((13, 11, 9), (2, 2, 2), 2), 1,
                                 f64)):
        gen.manual_seed(1400)
        card = {q: torch.rand(spec.stacked_shape_zyx(), generator=gen, device=dev,
                              dtype=f64).to(dt) for q in range(nq)}
        host = {q: t.cpu() for q, t in card.items()}
        halo_fill.self_fill.launches = 0
        HaloExchange(spec)(card)
        sync(dev)
        fills = halo_fill.self_fill.launches
        HaloExchange(spec)(host)
        check(all(torch.equal(card[q].cpu(), host[q]) for q in card),
              f"resident uneven exchange {label}: card != CPU")
        want_fills = -(-nq * spec.num_blocks() // halo_fill.MAX_FILL_GROUP) \
            if spec.dim.z == 1 and on_card else 0
        check(fills == want_fills, f"resident uneven exchange {label}: {fills} fill launches, "
                                   f"expected {want_fills}")
        log(f"resident uneven exchange {label} (sizes x {spec.sizes_x}, y {spec.sizes_y}, z "
            f"{spec.sizes_z}): card == CPU on every cell; {fills} fill launch(es)")
        del card, host
    dd = DistributedDomain(n, n, n, device=dev)
    dd.set_radius(3)
    dd.set_partition((3, 2, 1))
    for i in range(4):
        dd.add_data(f"q{i}", "float32")
    dd.realize()
    loop10 = dd.exchange_loop(10)
    ex_ms = time_ms(lambda: loop10(dd.curr_state()), 3, warmup=1) / 10
    nbytes = dd.exchange_bytes_for_method(Method.AXIS_COMPOSED)
    log(f"resident uneven exchange {n}^3 (3,2,1) r3 x4 via exchange_loop: {ex_ms:.4f} ms, "
        f"{nbytes / ex_ms / 1e6:.2f} GB/s logical ({nbytes} bytes); uniform config 2 in this "
        f"run {c2_gbs if c2_gbs is None else f'{c2_gbs:.2f}'} GB/s")
    del dd, loop10

    # -- steps from a random field against the single-block default path --------
    spec1 = spec_of((n,) * 3, (1, 1, 1), 1)
    gen.manual_seed(1500)
    g = torch.rand((n, n, n), generator=gen, device=dev)
    ref, _ = make_jacobi_loop(HaloExchange(spec1), steps)(
        shard_blocks(g, spec1, dev), torch.zeros(spec1.stacked_shape_zyx(), device=dev),
        sphere_sel_blocks(spec1, dev))
    ref = unshard_blocks(ref, spec1)
    specr = spec_of((n,) * 3, (3, 2, 1), 1)
    for label, ex, c in (
            ("6 positions, plain", HaloExchange(spec6, rd, mesh=mesh6),
             shard_blocks(g, spec6, mesh6)),
            ("6 positions, fused (host schedule)", HaloExchange(spec6, rd, mesh=mesh6, fused=True),
             shard_blocks(g, spec6, mesh6)),
            ("(3,2,1) residents", HaloExchange(specr), shard_blocks(g, specr, dev))):
        on_mesh = ex.on_mesh
        loop = make_jacobi_loop(ex, steps)
        check(loop.temporal_k == 0, f"jacobi {label}: multistep depth {loop.temporal_k} on an "
                                    "uneven partition")
        nxt = [torch.zeros_like(b) for b in c] if on_mesh else torch.zeros_like(c)
        out, _ = loop(c, nxt, sphere_sel_blocks(ex.spec, mesh6 if on_mesh else dev))
        got = unshard_blocks(out, ex.spec)
        check(np.array_equal(got, ref), f"jacobi {n}^3 {steps} steps over {label} != the "
                                        "single-block default path")
        log(f"jacobi {n}^3 {steps} steps over {label}: == the single-block default path")
        del ex, c, out, got, nxt
    del g, ref

    # -- the main paths, launch counts reset just before and read just after ----
    # one sweep_positions launch a step sweeps the 6 positions, one
    # sweep_regions launch the 36 shells (every side of every position)
    counted = {"remote_axis": rdma.remote_axis, "jacobi_sweep": sk.sweep,
               "jacobi_sweep_positions_uneven": sk.sweep_positions, "self_fill": halo_fill.self_fill,
               "jacobi_sweep_regions_uneven": sk.sweep_regions,
               "jacobi_multistep": sk.multistep, "fused_jacobi_mesh": fst.fused_jacobi_mesh,
               "fused_exchange": fst.fused_exchange}
    total = iters + chunk  # the warm-up chunk advances the state
    launches = {}
    for label, kw, per_step in (
            ("6 positions, plain", dict(devices=[dev] * 6, method=rd),
             {"remote_axis": 2, "jacobi_sweep_positions_uneven": 1, "self_fill": 1}),
            ("6 positions, fused", dict(devices=[dev] * 6, method=rd, kernel_variant="fused"),
             {"remote_axis": 2, "jacobi_sweep_positions_uneven": 1, "self_fill": 1,
              "jacobi_sweep_regions_uneven": 1}),
            ("(3,2,1) residents", dict(device=dev, partition=(3, 2, 1)),
             {"jacobi_sweep": 1, "self_fill": 1})):
        for fn in counted.values():
            fn.launches = 0
        rv = jacobi3d.run(n, n, n, iters=iters, chunk=chunk, weak=False, **kw)
        sync(dev)
        got = {name: fn.launches for name, fn in counted.items()}
        want = {name: total * per_step.get(name, 0) * on_card for name in counted}
        check(tuple(rv["domain"].spec.dim) == (3, 2, 1) and rv["temporal_k"] == 0,
              f"jacobi3d {label}: partition {rv['domain'].spec.dim}, k {rv['temporal_k']}")
        check(got == want, f"jacobi3d {n}^3 over {label}: launches {got}, expected {want}")
        if label == "6 positions, plain":
            launches["remote_axis_uneven"] = got["remote_axis"]
            launches["jacobi_sweep_positions_uneven"] = got["jacobi_sweep_positions_uneven"]
        if label == "6 positions, fused":
            launches["jacobi_sweep_regions_uneven"] = got["jacobi_sweep_regions_uneven"]
        fin = rv["domain"].get_curr_global(rv["handle"])
        check(bool(np.isfinite(fin).all()) and float(fin.min()) >= 0.0
              and float(fin.max()) <= 1.0, f"jacobi3d {label}: field not finite or out of range")
        log(jacobi3d.csv_row(rv))
        log(f"jacobi3d {n}^3 strong over {label} (sizes x {rv['domain'].spec.sizes_x}): "
            f"{rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), {rv['mcells_per_s']:.1f} "
            f"Mcells/s, launches {got}")
        del rv, fin

    # -- B1 over the 6 uneven positions and their 36 shells, one launch each:
    #    against the plain versions, then where the two uneven steps' device
    #    time goes, each launch alone
    bspec6 = spec6.block_spec()
    c6 = from_global(torch.rand((n, n, n), generator=gen, device=dev), spec6, mesh6)
    sel6 = sphere_sel_blocks(spec6, mesh6)
    n6 = [torch.zeros_like(b) for b in c6]
    rg6 = [sk.block_sel_range(spec6, Dim3.of(pos).z) for pos in mesh6.positions()]
    rects6 = [shells.shell_regions(spec6, shells.dyn_block_sizes(spec6, pos), (True,) * 3)
              for pos in mesh6.positions()]
    gen.manual_seed(12)
    rnd6 = [torch.randint(-1, 4, b.shape, generator=gen, device=dev, dtype=torch.int32)
            for b in c6]
    for what, s6, rg in (("spheres on their planes", sel6, rg6), ("random sel", rnd6, None)):
        rgs = rg or [None] * len(c6)
        got = sk.sweep_positions(c6, [b.clone() for b in n6], s6, bspec6, rg)
        want = [sk.sweep_plain(c, b.clone(), s, bspec6, fst.NO_WRAP, r)
                for c, b, s, r in zip(c6, n6, s6, rgs)]
        outs = sk.sweep_regions(c6, [b.clone() for b in n6], s6, bspec6, rects6, rg)
        wants = [b.clone() for b in n6]
        for c, o, s, rs, r in zip(c6, wants, s6, rects6, rgs):
            for rect in rs:
                sk.region_plain(c, o, s, bspec6, rect, r)
        sync(dev)
        errs["jacobi_sweep_positions_uneven"] = max(errs.get("jacobi_sweep_positions_uneven", 0.0),
                                          *(max_abs(a, b) for a, b in zip(got, want)))
        errs["jacobi_sweep_regions_uneven"] = max(errs.get("jacobi_sweep_regions_uneven", 0.0),
                                                 *(max_abs(a, b) for a, b in zip(outs, wants)))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"sweep of 6 uneven positions, {what}: kernel != plain")
        check(all(torch.equal(a, b) for a, b in zip(outs, wants)),
              f"the 36 shells of 6 uneven positions, {what}: kernel != plain")
    log(f"sweep_positions over 6 uneven positions {spec6.sizes_x} x {spec6.sizes_y} and "
        f"sweep_regions of their {sum(len(r) for r in rects6)} shells: equal with the spheres "
        "on their planes and random sel")
    del rnd6, got, want, outs, wants
    whole6 = [Rect3(bspec6.compute_offset(), bspec6.compute_offset() + bspec6.base)]
    nb6 = [sk.sweep_bytes(bspec6, whole6, r) for r in rg6]
    timings["jacobi_sweep_positions_uneven"] = b1_times(
        time_ms, dev, lambda: sk.sweep_positions(c6, n6, sel6, bspec6, rg6),
        lambda: [sk.sweep_plain(c, b, s, bspec6, fst.NO_WRAP, r)
                 for c, b, s, r in zip(c6, n6, sel6, rg6)],
        (sum(f for f, _ in nb6), sum(g for _, g in nb6)), plain_reps=1)
    b1_log("jacobi_sweep_positions_uneven", timings["jacobi_sweep_positions_uneven"],
           f"6 positions of {bspec6.base.x}x{bspec6.base.y}x{bspec6.base.z} in one launch")
    nb6 = [sk.sweep_bytes(bspec6, rs, r) for rs, r in zip(rects6, rg6)]
    timings["jacobi_sweep_regions_uneven"] = b1_times(
        time_ms, dev, lambda: sk.sweep_regions(c6, n6, sel6, bspec6, rects6, rg6),
        lambda: [sk.region_plain(c, b, s, bspec6, rect, r)
                 for c, b, s, rs, r in zip(c6, n6, sel6, rects6, rg6) for rect in rs],
        (sum(f for f, _ in nb6), sum(g for _, g in nb6)), plain_reps=1)
    b1_log("jacobi_sweep_regions_uneven", timings["jacobi_sweep_regions_uneven"],
           f"the {sum(len(r) for r in rects6)} shells of 6 positions in one launch")
    sweep_ms = [time_ms(lambda i=i: sk.sweep(c6[i], n6[i], sel6[i], bspec6, fst.NO_WRAP,
                                             rg6[i]), 20, graph=True) for i in (0, 2)]
    fill_ms = time_ms(lambda: rdma.self_wrap_positions({0: c6}, [0], spec6, "z"), 20, graph=True)
    log(f"uneven step over 6 positions, device ms per launch: the 6 positions' sweep "
        f"{timings['jacobi_sweep_positions_uneven']['ms']:.4f} (one position alone {sweep_ms[0]:.4f}, "
        f"{spec6.sizes_x[0]} wide; {sweep_ms[1]:.4f}, {spec6.sizes_x[2]} wide); z fill of "
        f"the 6 blocks {fill_ms:.4f}; the 36 shells "
        f"{timings['jacobi_sweep_regions_uneven']['ms']:.4f}")
    timings["jacobi_sweep_positions_uneven"]["extra"].update(position_171_ms=sweep_ms[0],
                                                   position_170_ms=sweep_ms[1])
    del c6, sel6, n6
    cr = shard_blocks(torch.rand((n, n, n), generator=gen, device=dev), specr, dev)
    selr, nr = sphere_sel_blocks(specr, dev), torch.zeros_like(cr)
    exr = HaloExchange(specr)
    rsweep_ms = time_ms(lambda: sk.sweep(cr, nr, selr, specr, fst.NO_WRAP,
                                         sk.block_sel_ranges(specr)), 20, graph=True)
    rex_ms = time_ms(lambda: exr(cr), 10, warmup=1)
    log(f"uneven step over (3,2,1) residents: the stacked sweep {rsweep_ms:.4f} ms per launch; "
        f"the exchange (indexed copies, rolls and one fill) {rex_ms:.4f} ms")
    del cr, selr, nr, exr

    # -- a guarded uneven run, and a checkpoint across partitions ---------------
    with tempfile.TemporaryDirectory(prefix="chip-smoke-uneven-") as tmp:
        kw = dict(iters=8, weak=False, health_every=2, ckpt_every=2, rollback_backoff=0.01,
                  devices=[dev] * 6, method=rd)
        clean = jacobi3d.run(gn, gn, gn, ckpt_dir=os.path.join(tmp, "clean"), **kw)
        check(not clean["domain"].spec.is_uniform(), f"guarded {gn}^3 over 6: uniform")
        nan = jacobi3d.run(gn, gn, gn, ckpt_dir=os.path.join(tmp, "nan"), inject="nan@3", **kw)
        a = nan["domain"].get_curr_global(nan["handle"])
        check(np.array_equal(a, clean["domain"].get_curr_global(clean["handle"])),
              f"guarded jacobi3d {gn}^3 over 6 positions nan@3: != the clean run")
        log(f"guarded jacobi3d {gn}^3 over 6 positions {tuple(clean['domain'].spec.dim)} nan@3: "
            f"rolled back, == the clean run ({nan['health_checks']} health checks)")
        del clean, nan
        dd = DistributedDomain(gn, gn, gn, device=dev)
        dd.set_devices([dev] * 6)
        dd.set_methods(rd)
        dd.set_radius(1)
        h = dd.add_data("temperature", "float32")
        dd.realize()
        gen.manual_seed(1600)
        gg = torch.rand((gn, gn, gn), generator=gen, device=dev).cpu().numpy()
        dd.set_curr_global(h, gg)
        dd.save_checkpoint(os.path.join(tmp, "ck"), 4, asynchronous=False)
        back = DistributedDomain(gn, gn, gn, device=dev)
        back.set_devices([dev] * 8)
        back.set_methods(rd)
        back.set_radius(1)
        bh = back.add_data("temperature", "float32")
        back.realize()
        check(back.restore_checkpoint(os.path.join(tmp, "ck")) == 4
              and np.array_equal(back.get_curr_global(bh), gg),
              "checkpoint written on (3,2,1), restored on (2,2,2): != the saved state")
        log(f"checkpoint {gn}^3 written on {tuple(dd.spec.dim)} positions, restored on "
            f"{tuple(back.spec.dim)}: == on the compute region")
    return timings, launches, errs


# (registers, threads, blocks per SM) of the fp32 instantiations that the
# float64 forms share a body with (B2 at k=3, B8, B1), as their redesigns
# built them: the element-type templates leave them as they were
FP32_BUILDS = {"jacobi_multistep": (80, 736, 1), "fused_jacobi": (56, 352, 3),
               "jacobi_sweep": (72, 352, 2)}
# the unnarrowed row-move body's registers (B6 and B7), fp32 and fp64 words
ROW_MOVE_REGS = 32

# the float64 forms in the {"kernels": [...]} line, each beside the fp32
# entry whose source and TPU builder it shares
FP64_FORMS = {"jacobi_sweep_f64": "jacobi_sweep", "jacobi_sweep_batched_f64": "jacobi_sweep_batched",
              "jacobi_sweep_regions_f64": "jacobi_sweep_regions",
              "jacobi_sweep_positions_f64": "jacobi_sweep_positions",
              "jacobi_sweep_positions_uneven_f64": "jacobi_sweep_positions_uneven",
              "jacobi_sweep_regions_uneven_f64": "jacobi_sweep_regions_uneven",
              "jacobi_multistep_f64": "jacobi_multistep",
              "jacobi_multistep_deep_halo_f64": "jacobi_multistep_deep_halo"}


def fp64_phase(dev, time_ms, n: int = 512, tenant_edges=(128, 32), tenants: int = 64,
               iters: int = 50, chunk: int = 25, small=((67, 45, 29), (130, 70, 40))):
    """Phase 13, Jacobi in float64 on ``dev``: the fp64 instantiations of B1
    (csrc/jacobi_sweep.cu) and B2/B3 (csrc/jacobi_multistep.cu) against
    their plain versions with torch.equal, from random fields with noise in
    every halo, and the float64 main paths with their launch counts.

    - B1, one block at phase 2's shapes (``n``^3 r1, 100x70x50 unaligned,
      256x64x40 tight-x, 33x21x13 r2 with z and x halos read, ``n``^3
      tight-x all-wrap, 67x45x29, 130x70x40), each with random sel codes in
      [-1, 4) on every plane and on 6 planes, and the spheres on their
      planes; the tenant stacks of ``tenants`` x ``tenant_edges``^3
      (unaligned: pitches 130 and 34); the stacked (2,2,2) r4 sweep of
      ``n``^3 and its 48 shells in one launch; the 8 positions of
      (``n``/2)^3; the 6 uneven positions of ``n``^3 over (3,2,1) and their
      36 shells; each form timed per launch at the main path's shape beside
      its plain version, its bound (sel on its planes, 16 bytes a cell plus
      4 on those planes) and a three-stream fp64 torch.add of as many cells.
    - B2, every depth k = 1..6 on the ``small`` shapes (one and several z
      chunks), and the deep-halo form on (2,2,2) ``n``^3 r4 at k = 2..4;
      each form timed at the planner's depth beside its plain version and
      its bytes bound.
    - The main paths, launch counts set to 0 just before and read just
      after: ``apps.jacobi3d.run(n, n, n, dtype="float64")`` on one block
      (``iters`` steps in chunks of ``chunk`` after a warm-up chunk:
      multistep passes and sweep tails as in fp32), over (2,2,2) residents
      with deep halo 4 and 1, over 8 positions (plain remote-dma) and over 6
      uneven positions (plain, and fused by the host schedule), each final
      field float64, finite, in [0, 1] with the spheres held; 2k + 2 steps
      at ``n``^3 through the kernels bit-equal to the plain versions; and
      the campaign CLI's A/B ``--dtype float64 --check-parity`` at
      ``tenants`` tenants of each edge (6 tenant sweeps and 2 multistep
      passes a tenant).

    Sizes are arguments so that the phase can be rehearsed on the CPU (where
    the plain versions count no launch). Returns ``(timings, launches,
    errs)``, keyed by the names of :data:`FP64_FORMS`."""
    from stencil_tpu_torch import GridSpec
    from stencil_tpu_torch.apps import campaign as campaign_app
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.geometry import Dim3, Radius, Rect3
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.ops import halo_fill, shells
    from stencil_tpu_torch.ops import remote_dma as rdma
    from stencil_tpu_torch.ops import stencil_kernels as sk
    from stencil_tpu_torch.ops.jacobi import (make_jacobi_loop, multi_block_layout,
                                              sphere_sel_blocks)
    from stencil_tpu_torch.parallel import DeviceMesh, HaloExchange, Method
    from stencil_tpu_torch.utils.roofline import bound_ms

    f64 = torch.float64
    on_card = dev.type == "cuda"  # the plain versions (a CPU rehearsal) count no launch
    gen = torch.Generator(device=dev)
    kp = sk.MULTISTEP_KPLAN
    errs = {name: 0.0 for name in FP64_FORMS}
    timings, launches = {}, {}

    def spec_of(size, part=(1, 1, 1), r=1, aligned=True, tight_x=False):
        rad = Radius.constant(r)
        return GridSpec(Dim3(*size), Dim3(*part), rad.without_x() if tight_x else rad,
                        aligned=aligned)

    def rand(shape, seed):
        gen.manual_seed(seed)
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)

    def rsel(shape, seed):
        gen.manual_seed(seed)
        return torch.randint(-1, 4, shape, generator=gen, device=dev, dtype=torch.int32)

    def held(name, pairs, label):
        sync(dev)
        pairs = list(pairs)
        errs[name] = max(errs[name], *(max_abs(a, b) for a, b in pairs))
        check(all(torch.equal(a, b) for a, b in pairs), f"{name} {label}: kernel != plain")

    def whole(spec):
        off = spec.compute_offset()
        return [Rect3(off, off + spec.base)]

    def timed(name, what, run, plain, nbytes, reps=20):
        timings[name] = b1_times(time_ms, dev, run, plain, nbytes, reps, 1, f64)
        b1_log(name, timings[name], what)

    # -- B1, one block: phase 2's shapes -----------------------------------------
    cases = [(f"{n}^3 r1", spec_of((n,) * 3), (True,) * 3),
             ("100x70x50 r1 unaligned", spec_of((100, 70, 50), aligned=False), (True,) * 3),
             ("256x64x40 tight-x", spec_of((256, 64, 40), tight_x=True), (True,) * 3),
             ("33x21x13 r2 z/x halos read", spec_of((33, 21, 13), r=2), (False, True, False)),
             (f"{n}^3 tight-x all-wrap", spec_of((n,) * 3, tight_x=True), (True,) * 3),
             ("67x45x29", spec_of((67, 45, 29)), (True,) * 3),
             ("130x70x40", spec_of((130, 70, 40)), (True,) * 3)]
    for i, (label, spec, wrap) in enumerate(cases):
        shape = spec.stacked_shape_zyx()
        c = rand(shape, 1300 + i)
        z0 = spec.compute_offset().z
        for what, sel, rg in (("random sel", rsel(shape, 1310 + i), None),
                              ("random sel on 6 planes", rsel(shape, 1320 + i), (z0 + 3, z0 + 9)),
                              ("spheres on their planes", sphere_sel_blocks(spec, dev),
                               sk.sel_z_range(spec))):
            held("jacobi_sweep_f64", [(sk.sweep(c, torch.zeros_like(c), sel, spec, wrap, rg),
                                       sk.sweep_plain(c, torch.zeros_like(c), sel, spec, wrap,
                                                      rg))], f"{label}, {what}")
        log(f"sweep fp64 {label} (tile "
            f"{sk.sweep_tile(spec.base.x, spec.base.y, spec.compute_offset().x, 8)}): equal with "
            "random sel, random sel on 6 planes and the spheres on their planes")
    spec1 = cases[0][1]
    c = rand(spec1.stacked_shape_zyx(), 1307)
    nx, sel1, rg1 = torch.zeros_like(c), sphere_sel_blocks(spec1, dev), sk.sel_z_range(spec1)
    timed("jacobi_sweep_f64", f"{n}^3 one block, sel on its planes",
          lambda: sk.sweep(c, nx, sel1, spec1, (True,) * 3, rg1),
          lambda: sk.sweep_plain(c, nx, sel1, spec1, (True,) * 3, rg1),
          sk.sweep_bytes(spec1, whole(spec1), rg1, item=8))
    timings["jacobi_sweep_f64"]["extra"]["every_plane_ms"] = time_ms(
        lambda: sk.sweep(c, nx, sel1, spec1), 20, graph=True)
    del c, nx

    # -- B1, the campaign's tenant stacks ------------------------------------------
    for i, edge in enumerate(tenant_edges):
        spec = spec_of((edge,) * 3, aligned=False)
        p = spec.padded()
        shape = (tenants, p.z, p.y, p.x)
        c = rand(shape, 1330 + i)
        sph = sphere_sel_blocks(spec, dev).view(1, p.z, p.y, p.x).expand(tenants, -1, -1, -1)
        sph, rg = sph.contiguous(), sk.sel_z_range(spec)
        for what, sel, r in (("random sel", rsel(shape, 1335 + i), None),
                             ("the spheres on their planes", sph, rg)):
            held("jacobi_sweep_batched_f64",
                 [(sk.sweep_tenants(c, torch.zeros_like(c), sel, spec, r),
                   sk.sweep_plain(c, torch.zeros_like(c), sel, spec, sel_range=r))],
                 f"B={tenants} of {edge}^3, {what}")
        log(f"tenant sweep fp64 B={tenants} of {edge}^3 (pitch {p.x}): equal with random sel "
            "and the spheres on their planes")
        if i == 0:
            nx = torch.zeros_like(c)
            timed("jacobi_sweep_batched_f64", f"B={tenants} of {edge}^3, the spheres on their "
                  "planes", lambda: sk.sweep_tenants(c, nx, sph, spec, rg),
                  lambda: sk.sweep_plain(c, nx, sph, spec, sel_range=rg),
                  sk.sweep_bytes(spec, whole(spec), rg, tenants, 8))
        del c, sph

    # -- B1, the stacked (2,2,2) r4 sweep and its 48 shells ---------------------------
    spec_h = spec_of((n,) * 3, (2, 2, 2), 4)
    wrap_h, _axes, shells_h = multi_block_layout(spec_h)
    shape = spec_h.stacked_shape_zyx()
    c = rand(shape, 1340)
    sph_h, rg_h = sphere_sel_blocks(spec_h, dev), sk.block_sel_ranges(spec_h)
    for what, sel, rg in (("random sel", rsel(shape, 1341), None),
                          ("the spheres on each block's planes", sph_h, rg_h)):
        got = sk.sweep(c, torch.zeros_like(c), sel, spec_h, wrap_h, rg)
        want = sk.sweep_plain(c, torch.zeros_like(c), sel, spec_h, wrap_h, rg)
        sk.sweep_regions([c], [got], [sel], spec_h, [shells_h], [rg])
        for rect in shells_h:
            sk.region_plain(c, want, sel, spec_h, rect, rg)
        held("jacobi_sweep_regions_f64", [(got, want)], f"(2,2,2) r4 stack and shells, {what}")
    log(f"stacked sweep fp64 {n}^3 (2,2,2) r4 + its {len(shells_h) * 8} shells in one launch: "
        "equal with random sel and the spheres on each block's planes")
    nx = torch.zeros_like(c)
    timed("jacobi_sweep_regions_f64", f"{n}^3 (2,2,2) r4, the {len(shells_h) * 8} shells in "
          "one launch", lambda: sk.sweep_regions([c], [nx], [sph_h], spec_h, [shells_h], [rg_h]),
          lambda: [sk.region_plain(c, nx, sph_h, spec_h, rc, rg_h) for rc in shells_h],
          sk.sweep_bytes(spec_h, shells_h, rg_h, item=8), reps=10)
    del c, nx, got, want

    # -- B1 over the 8 positions and over the 6 uneven ones and their shells ------
    def positions(spec, seed, label, name, shell_name=None):
        mesh = DeviceMesh(spec.dim, [dev] * spec.dim.flatten())
        bspec = spec.block_spec()
        p = bspec.padded()
        bshape = (1, 1, 1, p.z, p.y, p.x)
        cs = [rand(bshape, seed + i) for i in range(len(mesh))]
        ns = [torch.zeros_like(b) for b in cs]
        sph = sphere_sel_blocks(spec, mesh)
        rgs = [sk.block_sel_range(spec, Dim3.of(pos).z) for pos in mesh.positions()]
        rects = [shells.shell_regions(spec, shells.dyn_block_sizes(spec, pos), (True,) * 3)
                 for pos in mesh.positions()]
        rnd = [rsel(bshape, seed + 20 + i) for i in range(len(mesh))]
        for what, sels, rg in (("the spheres on their planes", sph, rgs), ("random sel", rnd, None)):
            rl = rg or [None] * len(mesh)
            got = sk.sweep_positions(cs, [b.clone() for b in ns], sels, bspec, rg)
            want = [sk.sweep_plain(c, b.clone(), s, bspec, fst.NO_WRAP, r)
                    for c, b, s, r in zip(cs, ns, sels, rl)]
            held(name, zip(got, want), f"{label}, {what}")
            if shell_name:
                outs = sk.sweep_regions(cs, [b.clone() for b in ns], sels, bspec, rects, rg)
                wants = [b.clone() for b in ns]
                for c, o, s, rs, r in zip(cs, wants, sels, rects, rl):
                    for rect in rs:
                        sk.region_plain(c, o, s, bspec, rect, r)
                held(shell_name, zip(outs, wants), f"the shells of {label}, {what}")
        log(f"sweep_positions fp64 over {label}"
            + (f" and sweep_regions of their {sum(len(r) for r in rects)} shells" if shell_name
               else "") + ": equal with the spheres on their planes and random sel")
        nb = [sk.sweep_bytes(bspec, whole(bspec), r, item=8) for r in rgs]
        timed(name, f"{label} in one launch, each position's spheres on its planes",
              lambda: sk.sweep_positions(cs, ns, sph, bspec, rgs),
              lambda: [sk.sweep_plain(c, b, s, bspec, fst.NO_WRAP, r)
                       for c, b, s, r in zip(cs, ns, sph, rgs)],
              (sum(f for f, _ in nb), sum(g for _, g in nb)))
        if shell_name:
            nb = [sk.sweep_bytes(bspec, rs, r, item=8) for rs, r in zip(rects, rgs)]
            timed(shell_name, f"the {sum(len(r) for r in rects)} shells of {label} in one launch",
                  lambda: sk.sweep_regions(cs, ns, sph, bspec, rects, rgs),
                  lambda: [sk.region_plain(c, b, s, bspec, rect, r)
                           for c, b, s, rs, r in zip(cs, ns, sph, rects, rgs) for rect in rs],
                  (sum(f for f, _ in nb), sum(g for _, g in nb)), reps=10)

    positions(spec_of((n,) * 3, (2, 2, 2)), 1350, f"8 positions of {n // 2}^3",
              "jacobi_sweep_positions_f64")
    positions(spec_of((n,) * 3, (3, 2, 1)), 1380, f"6 uneven positions of {n}^3 (3,2,1)",
              "jacobi_sweep_positions_uneven_f64", "jacobi_sweep_regions_uneven_f64")

    # -- B2: every depth, one and several z chunks; the deep-halo form -------------
    chunk_counts = set()
    for size in small:
        spec = spec_of(size)
        for k in range(1, sk.MULTISTEP_KMAX + 1):
            c = rand(spec.stacked_shape_zyx(), 1390 + k)
            held("jacobi_multistep_f64", [(sk.multistep(c, torch.zeros_like(c), spec, k),
                                           sk.multistep_plain(c, torch.zeros_like(c), spec, k))],
                 f"{size} k={k}")
            if on_card:
                chunk_counts.add(min(2, sk.multistep_zchunks(
                    spec, k, sk.multistep_blocks_in_flight(dev, k, 8), 8)))
        log(f"multistep fp64 {'x'.join(map(str, size))} k=1..{sk.MULTISTEP_KMAX}: equal")
    check(not on_card or chunk_counts == {1, 2}, "multistep fp64 ran one z-chunk regime only")
    for k in range(2, 5):
        c = rand(spec_h.stacked_shape_zyx(), 1400 + k)
        held("jacobi_multistep_deep_halo_f64",
             [(sk.multistep(c, torch.zeros_like(c), spec_h, k),
               sk.multistep_plain(c, torch.zeros_like(c), spec_h, k))], f"(2,2,2) r4 k={k}")
    log(f"deep-halo multistep fp64 {n}^3 (2,2,2) r4 k=2..4: equal")
    cells = n ** 3
    c = rand(spec1.stacked_shape_zyx(), 1410)
    nx = torch.zeros_like(c)
    timings["jacobi_multistep_f64"] = dict(
        ms=time_ms(lambda: sk.multistep(c, nx, spec1, kp), 5, warmup=1, graph=True),
        plain_ms=time_ms(lambda: sk.multistep_plain(c, nx, spec1, kp), 1, warmup=1),
        bound=bound_ms(2 * 8 * cells, 6 * kp * cells, f64), library_ms=None)
    c = rand(spec_h.stacked_shape_zyx(), 1411)
    nx = torch.zeros_like(c)
    grown = 8 * (n // 2 + 2 * kp) ** 3
    timings["jacobi_multistep_deep_halo_f64"] = dict(
        ms=time_ms(lambda: sk.multistep(c, nx, spec_h, kp), 5, warmup=1, graph=True),
        plain_ms=time_ms(lambda: sk.multistep_plain(c, nx, spec_h, kp), 1, warmup=1),
        bound=bound_ms(8 * (grown + cells), 6 * kp * cells, f64), library_ms=None)
    for name in ("jacobi_multistep_f64", "jacobi_multistep_deep_halo_f64"):
        t = timings[name]
        log(f"time {name} {n}^3 k={kp}: {t['ms']:.4f} ms per launch, {t['ms'] / kp:.4f} ms per "
            f"step (plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by "
            f"{t['bound'][1]})")
    del c, nx

    # -- the main paths ------------------------------------------------------------
    # 2k + 2 steps through the kernels against the plain versions
    loop = make_jacobi_loop(HaloExchange(spec1), 2 * kp + 2)
    start = rand(spec1.stacked_shape_zyx(), 1420)
    c, nx = loop(start.clone(), torch.zeros_like(start), sel1)
    pc, pn = start.clone(), torch.zeros_like(start)
    for _ in range(2):
        pc, pn = sk.multistep_plain(pc, pn, spec1, kp), pc
    for _ in range(2):
        pc, pn = sk.sweep_plain(pc, pn, sel1, spec1), pc
    sync(dev)
    check(torch.equal(c, pc) and torch.equal(nx, pn),
          f"jacobi fp64 {n}^3 {2 * kp + 2} steps: kernel path != plain path")
    log(f"jacobi fp64 {n}^3 {2 * kp + 2} steps: kernel path == plain path")
    del loop, start, c, nx, pc, pn

    counted = {"jacobi_multistep": sk.multistep, "jacobi_sweep": sk.sweep,
               "jacobi_sweep_regions": sk.sweep_regions, "jacobi_sweep_positions": sk.sweep_positions,
               "remote_axis": rdma.remote_axis, "self_fill": halo_fill.self_fill}
    total = iters + chunk  # the warm-up chunk advances the state
    nch = total // chunk
    rd = Method.REMOTE_DMA
    hot, cold = sk.sphere_masks_from_coords(spec1, "cpu")
    # (label, run's arguments, its depth, launches, the kernels line's forms
    # whose launches it gives, by the wrapper that counts them)
    for label, kw, k_want, want, forms in (
            ("one block", dict(device=dev), kp,
             {"jacobi_multistep": nch * (chunk // kp), "jacobi_sweep": nch * (chunk % kp)},
             {"jacobi_sweep_f64": "jacobi_sweep", "jacobi_multistep_f64": "jacobi_multistep"}),
            ("(2,2,2) residents, deep_halo 4", dict(device=dev, partition=(2, 2, 2), deep_halo=4),
             kp, {"jacobi_multistep": nch * (chunk // kp), "jacobi_sweep": nch * (chunk % kp),
                  "jacobi_sweep_regions": nch * (chunk % kp)},
             {"jacobi_sweep_regions_f64": "jacobi_sweep_regions",
              "jacobi_multistep_deep_halo_f64": "jacobi_multistep"}),
            ("(2,2,2) residents, deep_halo 1", dict(device=dev, partition=(2, 2, 2)), 0,
             {"jacobi_sweep": total, "jacobi_sweep_regions": total}, {}),
            ("8 positions, plain remote-dma", dict(devices=[dev] * 8, method=rd), 0,
             {"remote_axis": 3 * total, "jacobi_sweep_positions": total},
             {"jacobi_sweep_positions_f64": "jacobi_sweep_positions"}),
            ("6 uneven positions, plain remote-dma", dict(devices=[dev] * 6, method=rd), 0,
             {"remote_axis": 2 * total, "jacobi_sweep_positions": total, "self_fill": total},
             {"jacobi_sweep_positions_uneven_f64": "jacobi_sweep_positions"}),
            ("6 uneven positions, fused (the host schedule)",
             dict(devices=[dev] * 6, method=rd, kernel_variant="fused"), 0,
             {"remote_axis": 2 * total, "jacobi_sweep_positions": total, "self_fill": total,
              "jacobi_sweep_regions": total},
             {"jacobi_sweep_regions_uneven_f64": "jacobi_sweep_regions"})):
        for fn in counted.values():
            fn.launches = 0
        rv = jacobi3d.run(n, n, n, iters=iters, chunk=chunk, weak=False, dtype="float64", **kw)
        sync(dev)
        got = {name: fn.launches for name, fn in counted.items()}
        wanted = {name: want.get(name, 0) * on_card for name in counted}
        check(got == wanted, f"jacobi3d fp64 {n}^3 {label}: launches {got}, expected {wanted}")
        check(rv["temporal_k"] == k_want, f"jacobi3d fp64 {label}: k={rv['temporal_k']}")
        fin = torch.from_numpy(rv["domain"].get_curr_global(rv["handle"]))
        check(fin.dtype == f64 and tuple(fin.shape) == (n,) * 3
              and bool(torch.isfinite(fin).all()) and float(fin.min()) >= 0.0
              and float(fin.max()) <= 1.0 and bool((fin[hot] == 1.0).all())
              and bool((fin[cold] == 0.0).all()),
              f"jacobi3d fp64 {label}: field not float64, not finite, out of range or spheres "
              "lost")
        launches.update({form: got[key] for form, key in forms.items()})
        log(jacobi3d.csv_row(rv))
        log(f"jacobi3d fp64 {n}^3 {label}: {rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), "
            f"{rv['mcells_per_s']:.1f} Mcells/s, temporal_k {rv['temporal_k']}, launches {got}")
        del rv, fin
    del hot, cold

    # the campaign CLI's A/B in float64 at each tenant edge
    counted8 = {"jacobi_sweep_batched": sk.sweep_tenants, "jacobi_sweep": sk.sweep,
                "jacobi_multistep": sk.multistep}
    for edge in tenant_edges:
        argv = ["--tenants", str(tenants), "--slot", str(tenants), "--size", str(edge),
                "--chunk", "3", "--steps", "6", "--mode", "ab", "--check-parity", "--dtype",
                "float64", "--device", str(dev)]
        for fn in counted8.values():
            fn.launches = 0
        with tempfile.TemporaryDirectory(prefix="chip-smoke-fp64-campaign-") as d:
            out = campaign_app.run_modes(campaign_app.parse_args(argv), os.path.join(d, "c"))
        sync(dev)
        got = {name: fn.launches for name, fn in counted8.items()}
        wanted = {"jacobi_sweep_batched": 6 * on_card, "jacobi_sweep": 0,
                  "jacobi_multistep": 2 * tenants * on_card}
        check(got == wanted, f"campaign A/B fp64 {tenants} x {edge}^3: launches {got}, "
                             f"expected {wanted}")
        check(out["parity"] == "ok" and out["evicted"] == [] and out["dtype"] == "float64",
              f"campaign A/B fp64 {tenants} x {edge}^3: parity {out['parity']}, evicted "
              f"{out['evicted']}")
        for res in out["_batched"]["results"].values():
            check(res.final.dtype == np.float64 and res.final.shape == (edge,) * 3
                  and bool(np.isfinite(res.final).all()),
                  f"campaign fp64 {edge}^3 tenant {res.tid}: not float64, finite and whole")
        launches.setdefault("jacobi_sweep_batched_f64", got["jacobi_sweep_batched"])
        log(f"campaign A/B fp64 {tenants} tenants of {edge}^3, 6 steps in chunks of 3: kernel "
            f"build {out['build_s']} s (outside the timed spans), batched "
            f"{out['batched_mcells_per_s']} Mcells/s (p50 {out['batched_p50_step_s']} s), "
            f"sequential {out['sequential_mcells_per_s']} Mcells/s (p50 "
            f"{out['sequential_p50_step_s']} s), ratio {out['batched_over_sequential']}, parity "
            f"{out['parity']}, launches {got}")
    return timings, launches, errs


def astaroth_resident_phase(dev, time_ms, n: int = 256, strong_nx: int = 128, iters: int = 10,
                            small_nx: int = 16, shell_edge: int = 64, timed: bool = True):
    """Phase 14, Astaroth over resident blocks on ``dev``: the table form of
    the substep kernel (``substep_tasks``, csrc/astaroth_substep.cu) and
    the app over a partition whose blocks all sit on the card.

    - The table form against its plain version with torch.equal, fp64 and
      fp32, stages 0-2, from random fields (halos and pad included) at dt
      0.1: every block's compute region of stacks ragged against the 32x4
      tile (40x24x20 over (2,2,2), 33x13x14 over (1,1,2)) and of an uneven
      partition (67x45x29 over (2,2,2): blocks of 34/33, 23/22 and 15/14);
      the 48-shell table of ``shell_edge``^3 over (2,2,2) and the uneven
      one's, at stage 0 (its tensor-copy and cp.async tasks side by side in
      fp64); fp64 stacks one cell off 16-byte alignment (every task on
      cp.async).
    - More tasks than one launch's table holds (the 540 shells of 80x72x48
      over (5,6,3), three launches), and the main path's shape: stages 0-2
      over the 8 residents of ``n``^3 and their 48 shells at stage 0, in
      fp64 and fp32, each plain pass timed.
    - ``apps.astaroth.run(partition=(2,2,2))`` at the conf's ``n``^3 a block
      (the JAX app's 8-device run) in fp64 and fp32, and at ``nx =
      strong_nx`` (``(2 strong_nx)``^3 global); in fp64 both with overlap
      and without, in turns (overlap, none, none, overlap); launch counts
      set to 0 just before and read just after each: 4 table launches an
      iteration with overlap (one of them the shells), 3 without, and no
      fill launch.
    - A (2,2,2) run of ``small_nx``^3 blocks, and 2 overlap iterations of
      the uneven 67x45x29, on the card against the same on the CPU (the
      plain versions, which the CPU tests hold to stencil_tpu): relative
      1e-10.
    - Timed (``timed``): the table launch over the 8 residents of ``n``^3 on
      the main path's stage mix, its 48-shell launch and the 8-field fp64
      exchange of those residents, each beside its bound and (but the
      exchange) its plain version.

    Sizes are arguments so that the phase can be rehearsed on the CPU (where
    the plain versions count no launch). Returns ``(timings, launches,
    errs)`` keyed ``astaroth_substep_resident`` and ``astaroth_substep_shells``."""
    from stencil_tpu_torch import GridSpec
    from stencil_tpu_torch.apps import astaroth as astaroth_app
    from stencil_tpu_torch.astaroth.equations import Constants
    from stencil_tpu_torch.astaroth.integrate import FIELDS, inv_ds_of, make_astaroth_step
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import astaroth_substep as asub
    from stencil_tpu_torch.ops import halo_fill
    from stencil_tpu_torch.parallel import HaloExchange, unshard_blocks
    from stencil_tpu_torch.utils.roofline import bound_ms

    on_card = dev.type == "cuda"  # the plain versions (a CPU rehearsal) count no launch
    gen = torch.Generator(device=dev)
    ainfo = astaroth_app.load()
    consts, ids = Constants.from_info(ainfo), inv_ds_of(ainfo)
    names = ("astaroth_substep_resident", "astaroth_substep_shells")
    errs = {name: 0.0 for name in names}
    timings, launches = {}, {}

    def spec_of(size, part):
        return GridSpec(Dim3(*size), Dim3(*part), Radius.constant(3))

    def rand8(spec, seed, dtype, offset=0):
        """8 random stacks (scaled to [0, 0.1)), ``offset`` cells into their
        buffers (off 16-byte alignment when odd in fp64)."""
        shape = spec.stacked_shape_zyx()
        out = []
        for f in range(8):
            gen.manual_seed(seed + f)
            flat = torch.rand(int(np.prod(shape)) + offset, generator=gen, device=dev,
                              dtype=dtype) * 0.1
            out.append(flat[offset:].view(shape))
        return out

    def held(name, label, spec, tasks, dtype, stages, offset=0, time_plain=None):
        """``stages`` through the kernel and through the plain version from
        the same out stacks, torch.equal on every cell, and the launches
        counted: one a stage per :data:`MAX_TASKS` tasks. With
        ``time_plain`` (the timer) each plain pass is timed; returns the
        plain ms by stage."""
        curr8 = rand8(spec, 1400, dtype, offset)
        ok, op = rand8(spec, 1500, dtype, offset), rand8(spec, 1500, dtype, offset)
        before, plain_ms = asub.substep_tasks.launches, {}
        for s in stages:
            asub.substep_tasks(curr8, ok, spec, tasks, consts, ids, s, 0.1)

            def plain(s=s):
                asub.substep_tasks_plain(curr8, op, spec, tasks, consts, ids, s, 0.1)

            if time_plain is None:
                plain()
            else:
                plain_ms[s] = time_plain(plain, 1, warmup=0)
        sync(dev)
        launched = asub.substep_tasks.launches - before
        want = len(stages) * -(-len(tasks) // asub.MAX_TASKS) * on_card
        check(launched == want, f"{name} {label}: {launched} launches, expected {want}")
        errs[name] = max(errs[name], *(max_abs(a, b) for a, b in zip(ok, op)))
        check(all(torch.equal(a, b) for a, b in zip(ok, op)),
              f"{name} {label}: kernel != plain version (max abs err {errs[name]:.3e})")
        item = torch.empty((), dtype=dtype).element_size()
        aligned = all(t.data_ptr() % 16 == 0 for t in curr8)
        tma = sum(r[-1] for r in asub.substep_table(tasks, spec, 132, item, aligned)[0])
        log(f"{name} {label} {str(dtype)[6:]} stages {list(stages)}: {len(tasks)} tasks "
            f"({tma} by tensor copies) in {launched} launch(es), equal")
        return plain_ms

    # -- the table form against its plain version -----------------------------------
    for dtype in (torch.float64, torch.float32):
        for size, part in (((40, 24, 20), (2, 2, 2)), ((33, 13, 14), (1, 1, 2)),
                           ((67, 45, 29), (2, 2, 2))):
            spec = spec_of(size, part)
            label = f"{'x'.join(map(str, size))} over {part}"
            held(names[0], label, spec, asub.compute_tasks(spec), dtype, (0, 1, 2))
            if size == (67, 45, 29):
                held(names[1], label + " shells", spec, asub.shell_tasks(spec), dtype, (0,))
        spec = spec_of((shell_edge,) * 3, (2, 2, 2))
        held(names[1], f"{shell_edge}^3 over (2, 2, 2) shells", spec, asub.shell_tasks(spec),
             dtype, (0,))
        # more tasks than one launch's table holds: the 540 shells of 90 blocks
        spec = spec_of((80, 72, 48), (5, 6, 3))
        held(names[1], "80x72x48 over (5, 6, 3) shells", spec, asub.shell_tasks(spec), dtype,
             (0,))
    spec = spec_of((40, 24, 20), (2, 2, 2))
    held(names[0], "40x24x20 over (2, 2, 2), fields one cell off alignment", spec,
         asub.compute_tasks(spec), torch.float64, (0, 1, 2), offset=1)

    # -- the main path: the app over (2,2,2) residents ----------------------------------
    def app_run(label, dtype, nx, overlap):
        asub.substep_tasks.launches = asub.substep_tasks.shells = 0
        halo_fill.self_fill.launches = 0
        ra = astaroth_app.run(iters=iters, nx=nx, dtype=dtype, overlap=overlap, device=dev,
                              partition=(2, 2, 2))
        sync(dev)
        it = ra["iters_run"] + 1  # the warm-up chunk advances the state
        got = (asub.substep_tasks.launches, asub.substep_tasks.shells,
               halo_fill.self_fill.launches)
        want = ((4 if overlap else 3) * it * on_card, it * overlap * on_card, 0)
        check(got == want, f"astaroth {label}: launches (table, of which shells, fill) {got}, "
                           f"expected {want}")
        dd, h = ra["domain"], ra["handles"]
        for k in FIELDS:
            t = dd.get_curr(h[k])
            check(tuple(t.shape) == dd.spec.stacked_shape_zyx() and t.dtype == getattr(torch, dtype)
                  and bool(torch.isfinite(t).all()), f"astaroth {label} {k}: not finite")
        check(dd.size == Dim3(2 * nx, 2 * nx, 2 * nx), f"astaroth {label}: global {dd.size}")
        log(astaroth_app.csv_row(ra))
        log(f"astaroth {label}: {ra['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), "
            f"{ra['mcells_per_s']:.1f} Mcells/s, exchange {ra['exch_trimean_s'] * 1e3:.4f} ms, "
            f"launches (table, of which shells, fill) {got}")
        return ra, got

    # overlap and no overlap in turns (overlap, none, none, overlap) at n^3 a
    # block and at strong_nx in fp64; overlap in fp32
    for dtype, nx, turns in (("float64", n, (True, False, False, True)), ("float32", n, (True,)),
                             ("float64", strong_nx, (True, False, False, True))):
        per = {True: [], False: []}
        for overlap in turns:
            ra, got = app_run(f"(2,2,2) x {nx}^3 a block {dtype}, "
                              f"{'overlap' if overlap else 'no overlap'}", dtype, nx, overlap)
            if (dtype, nx) == ("float64", n) and names[1] not in launches:
                launches[names[0]], launches[names[1]] = got[0] - got[1], got[1]
            per[overlap].append(ra["iter_trimean_s"] * 1e3)
            del ra
        if per[False]:
            gap = np.mean(per[True]) - np.mean(per[False])
            log(f"astaroth (2,2,2) x {nx}^3 a block {dtype} in turns: overlap "
                f"{', '.join(f'{v:.4f}' for v in per[True])}, no overlap "
                f"{', '.join(f'{v:.4f}' for v in per[False])} ms/iter (mean gap {gap:.4f} ms, "
                f"{100 * gap / np.mean(per[False]):.1f}% of no overlap)")

    # -- small runs on the card against the same on the CPU --------------------------
    rg = astaroth_app.run(iters=3, nx=small_nx, dt=1e-5, device=dev, partition=(2, 2, 2))
    rc = astaroth_app.run(iters=3, nx=small_nx, dt=1e-5, device="cpu", partition=(2, 2, 2))
    small_err = 0.0
    for k in FIELDS:
        a = rg["domain"].get_curr_global(rg["handles"][k])
        b = rc["domain"].get_curr_global(rc["handles"][k])
        small_err = max(small_err, float(np.abs(a - b).max() / np.abs(b).max()))
    check(small_err <= 1e-10, f"astaroth (2,2,2) x {small_nx}^3 card vs CPU: rel err "
                              f"{small_err:.3e}")
    log(f"astaroth (2,2,2) x {small_nx}^3 fp64 3 iterations, card vs CPU: max rel err "
        f"{small_err:.3e}")
    del rg, rc
    spec = spec_of((67, 45, 29), (2, 2, 2))
    state = {}
    for where in (dev, torch.device("cpu")):
        curr = {k: t.to(where) for k, t in zip(FIELDS, rand8(spec, 1600, torch.float64))}
        nxt = {k: torch.zeros_like(t) for k, t in curr.items()}
        step = make_astaroth_step(HaloExchange(spec), ainfo, dt=1e-5, iters=2, dtype="float64")
        curr, _ = step(curr, nxt)
        state[where.type] = {k: unshard_blocks(t.cpu(), spec) for k, t in curr.items()}
    uneven_err = max(float(np.abs(state[dev.type][k] - state["cpu"][k]).max()
                           / np.abs(state["cpu"][k]).max()) for k in FIELDS)
    check(uneven_err <= 1e-10, f"astaroth uneven 67x45x29 over (2,2,2): card vs CPU rel err "
                               f"{uneven_err:.3e}")
    log(f"astaroth uneven 67x45x29 over (2,2,2) fp64 2 iterations, card vs CPU: max rel err "
        f"{uneven_err:.3e}")
    del state, curr, nxt

    # -- the main path's shape: 8 residents of n^3 -------------------------------------
    # stages 0-2 over every block and the 48 shells at stage 0, each plain pass
    # timed once (its time is the kernels line's plain_ms)
    spec = spec_of((2 * n,) * 3, (2, 2, 2))
    full, shells = asub.compute_tasks(spec), asub.shell_tasks(spec)
    plain_ms = {}
    for dtype in (torch.float64, torch.float32):
        label = f"8 x {n}^3 over (2, 2, 2)"
        plain_ms[dtype] = (held(names[0], label, spec, full, dtype, (0, 1, 2), time_plain=time_ms),
                           held(names[1], label + " shells", spec, shells, dtype, (0,),
                                time_plain=time_ms)[0])

    if not timed:
        return timings, launches, errs
    for dtype in (torch.float64, torch.float32):
        item = torch.empty((), dtype=dtype).element_size()
        curr8, out8 = rand8(spec, 1700, dtype), rand8(spec, 1800, dtype)

        def run(tasks, s):
            return lambda: asub.substep_tasks(curr8, out8, spec, tasks, consts, ids, s, 1e-8)

        st = [time_ms(run(full, s), 4, warmup=1, graph=True) for s in (0, 1)]
        pl, pl_shells = plain_ms[dtype]
        cells = spec.global_size.flatten()
        nbytes = (asub.tasks_bytes(full, item, 0) + 2 * asub.tasks_bytes(full, item, 1)) / 3
        flops = (asub.FLOPS_PER_CELL[0] + 2 * asub.FLOPS_PER_CELL[1]) / 3 * cells
        t = dict(ms=(st[0] + 2 * st[1]) / 3, plain_ms=(pl[0] + pl[1] + pl[2]) / 3,
                 bound=bound_ms(nbytes, flops, dtype), library_ms=None)
        log(f"time astaroth_substep_resident 8 x {n}^3 {dtype}: {t['ms']:.4f} ms per launch on "
            f"the main path's mix (stage 0 {st[0]:.4f}, stages 1-2 {st[1]:.4f}; plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by {t['bound'][1]})")
        sh_cells = sum((r.hi - r.lo).flatten() for _, r in shells)
        ts = dict(ms=time_ms(run(shells, 0), 6, warmup=1, graph=True), plain_ms=pl_shells,
                  bound=bound_ms(asub.tasks_bytes(shells, item, 0),
                                 asub.FLOPS_PER_CELL[0] * sh_cells, dtype), library_ms=None)
        log(f"time astaroth_substep_shells 48 shells of 8 x {n}^3 {dtype}: {ts['ms']:.4f} ms per "
            f"launch ({sh_cells} cells; plain {ts['plain_ms']:.4f} ms, bound "
            f"{ts['bound'][0]:.4f} ms by {ts['bound'][1]})")
        if dtype == torch.float64:
            timings[names[0]], timings[names[1]] = t, ts
            # the 8-field exchange of the same residents (torch.roll and
            # copies: no kernel of the port on (2,2,2), every axis multi-block)
            ex = HaloExchange(spec)
            state = dict(zip(FIELDS, curr8))
            ex_ms = time_ms(lambda: ex(state), 5, warmup=1)
            nb = 2 * ex.bytes_logical([item] * 8)
            log(f"time astaroth exchange (2,2,2) x {n}^3 r3 8 fp64 fields: {ex_ms:.4f} ms "
                f"({nb / 2 / 1e6:.1f} MB of halos, read and written: bound "
                f"{bound_ms(nb, 0)[0]:.4f} ms by bytes)")
        del curr8, out8
    return timings, launches, errs


def surface_phase(dev, time_ms, n: int = 512, small=(67, 45, 29), iters: int = 50,
                  chunk: int = 25, steps: int = 8, pers_iters: int = 48, pers_chunk: int = 24,
                  ms_n: int = 512):
    """Phase 15, the rest of the one-card exchange surface, on ``dev``:
    DIRECT26 and REMOTE_DMA over (2,2,2) residents at ``n``^3 fp32 r1, each
    exchange bit-equal to AXIS_COMPOSED's on the same state (every compute
    and halo cell; REMOTE_DMA on every cell), timed with its GB/s logical and
    launch counts, and DIRECT26 on the uneven ``small`` (2,2,2) r2 fp32 +
    fp64 on the card against the CPU, every cell; B6 over the 8 resident
    endpoints against its plain version (torch.equal) and timed per launch;
    8 blocks on 4 mesh positions ((2,2,1), two z residents a position)
    bit-equal to the resident exchange; the main paths jacobi3d ``n``^3 over
    (2,2,2) with ``--direct26`` and with REMOTE_DMA (``iters`` steps in
    chunks of ``chunk`` after a warm-up chunk; one stacked B1 launch a step,
    and 3 B6 launches a step for REMOTE_DMA), launch counts reset just
    before and read just after; ``steps`` direct26 steps from a random field
    bit-equal to the same steps through the plain versions and to the
    resident axis-composed path; ``multistep_rows`` at each tile height the
    multistep kernel is built for (fp32: 32 at k <= 3, 16 deeper): the
    kernel ``torch.equal`` to the plain multistep at ``ms_n``^3, the loop
    with the legal height equal to the default loop, an unbuilt height
    refused; B9's uneven form at ``n``^3 over 6 positions (3,2,1), k=4 and a
    depth-3 tail chunk, ``torch.equal`` to ``persistent_jacobi_mesh_plain``
    (both buffers and sel), timed by CUDA events beside its bytes bound,
    ``steps`` steps bit-equal to the single-block default path, and
    ``apps.jacobi3d.run`` at ``n``^3 over those 6 positions with
    ``kernel_variant="persistent"``, ``deep_halo=4`` (``pers_iters`` steps
    in chunks of ``pers_chunk``), launch counts reset around it. Sizes are
    arguments so the phase can be rehearsed on the CPU (``time_ms`` a
    stand-in). Returns ``(timings, launches, errs)``."""
    from stencil_tpu_torch import GridSpec
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.geometry import Dim3, Radius, Rect3
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.ops import halo_fill
    from stencil_tpu_torch.ops import persistent_stencil as pst
    from stencil_tpu_torch.ops import remote_dma as rdma
    from stencil_tpu_torch.ops import stencil_kernels as sk
    from stencil_tpu_torch.ops.jacobi import (check_multistep_rows, make_jacobi_loop,
                                              multistep_heights, sphere_sel_blocks)
    from stencil_tpu_torch.parallel import (DeviceMesh, HaloExchange, Method, join_positions,
                                            split_positions, unshard_blocks)
    from stencil_tpu_torch.utils.roofline import bound_ms

    f32, f64 = torch.float32, torch.float64
    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev)
    rd, d26 = Method.REMOTE_DMA, Method.DIRECT26
    on_card = dev.type == "cuda"  # the plain versions (a CPU rehearsal) count no launch
    timings, launches, errs = {}, {}, {}

    def rand_stack(spec, seed, dtype=f32):
        gen.manual_seed(seed)
        return torch.rand(spec.stacked_shape_zyx(), generator=gen, device=dev,
                          dtype=f64).to(dtype)

    def halo_boxes(spec, r):
        """Each block's compute region grown by ``r``: (block index, slices)."""
        off = spec.compute_offset()
        for iz, iy, ix in np.ndindex(spec.dim.z, spec.dim.y, spec.dim.x):
            s = spec.block_size((ix, iy, iz))
            yield (iz, iy, ix), (slice(off.z - r, off.z + s.z + r),
                                 slice(off.y - r, off.y + s.y + r),
                                 slice(off.x - r, off.x + s.x + r))

    def halos_equal(a, b, spec, r):
        return all(torch.equal(a[j][box], b[j][box]) for j, box in halo_boxes(spec, r))

    counted = {"remote_axis": rdma.remote_axis, "jacobi_sweep": sk.sweep,
               "self_fill": halo_fill.self_fill, "jacobi_multistep": sk.multistep,
               "sweep_regions": sk.sweep_regions, "sweep_positions": sk.sweep_positions,
               "persistent_jacobi_mesh": pst.persistent_jacobi_mesh,
               "fused_jacobi_mesh": fst.fused_jacobi_mesh, "fused_exchange": fst.fused_exchange}

    def reset():
        for fn in counted.values():
            fn.launches = 0
        pst.persistent_jacobi_mesh.uneven = 0

    def read():
        return {name: fn.launches for name, fn in counted.items()}

    # -- DIRECT26 and REMOTE_DMA over (2,2,2) residents --------------------------
    spec = GridSpec(Dim3(n, n, n), Dim3(2, 2, 2), Radius.constant(1))
    base = rand_stack(spec, 1500)
    ref = base.clone()
    HaloExchange(spec)(ref)
    comp = HaloExchange(spec)
    t_c = base.clone()
    comp_ms = time_ms(lambda: comp(t_c), 10)
    nbytes = comp.bytes_logical([4])
    log(f"axis-composed exchange {n}^3 (2,2,2) r1 residents: {comp_ms:.4f} ms, "
        f"{nbytes / comp_ms / 1e6:.2f} GB/s logical")
    per_exchange = {d26: {}, rd: {"remote_axis": 3}}
    for m in (d26, rd):
        ex = HaloExchange(spec, m)
        t = base.clone()
        reset()
        ex(t)
        sync(dev)
        got = read()
        want = {name: per_exchange[m].get(name, 0) * on_card for name in counted}
        check(got == want, f"{m.value} exchange over residents: launches {got}, expected {want}")
        check(halos_equal(t, ref, spec, 1), f"{m.value} exchange over (2,2,2) residents != "
                                            "axis-composed on a compute or halo cell")
        check(m == d26 or torch.equal(t, ref), "remote-dma over residents != axis-composed")
        ms = time_ms(lambda: ex(t), 10)
        log(f"{m.value} exchange {n}^3 (2,2,2) r1 residents: == axis-composed on every compute "
            f"and halo cell{' (and every cell)' if m == rd else ''}; {ms:.4f} ms, "
            f"{nbytes / ms / 1e6:.2f} GB/s logical ({ex.bytes_moved([4])} bytes moved), "
            f"launches {dict((k, v) for k, v in got.items() if v)}")
        timings[f"exchange_{m.value}"] = ms
        del t, ex

    # DIRECT26 on an uneven partition of mixed dtypes, the card against the CPU
    sspec = GridSpec(Dim3(*small), Dim3(2, 2, 2), Radius.constant(2))
    st = {0: rand_stack(sspec, 1501), 1: rand_stack(sspec, 1502, f64)}
    st_cpu = {k: v.to(cpu) for k, v in st.items()}
    HaloExchange(sspec, d26)(st)
    HaloExchange(sspec, d26)(st_cpu)
    check(all(torch.equal(st[k].to(cpu), st_cpu[k]) for k in st),
          "direct26 uneven exchange: card != CPU")
    log(f"direct26 exchange {'x'.join(map(str, small))} (2,2,2) r2 fp32 + fp64: card == CPU on "
        "every cell (dead pad included)")
    del st, st_cpu

    # -- B6 over the 8 resident endpoints against its plain version -------------------
    ex_r = HaloExchange(spec, rd)
    remote = ex_r._remote
    bmesh = remote._block_mesh(dev)
    t = base.clone()
    ends = remote._endpoints(t)
    pl = base.clone()
    pends = remote._endpoints(pl)
    per = []
    errs["remote_axis_resident"] = 0.0
    for ph in remote.block_plan.remote_phases:
        rdma.remote_axis([[b] for b in ends], spec, ph, bmesh)
        rdma.remote_axis_plain([[b] for b in pends], spec, ph, bmesh)
        sync(dev)
        errs["remote_axis_resident"] = max(errs["remote_axis_resident"], max_abs(t, pl))
        check(torch.equal(t, pl), f"remote_axis over resident endpoints {ph.axis}: kernel != plain")
        ms = time_ms(lambda ph=ph: rdma.remote_axis([[b] for b in ends], spec, ph, bmesh), 20,
                     graph=True)
        plain = time_ms(lambda ph=ph: rdma.remote_axis_plain([[b] for b in pends], spec, ph,
                                                             bmesh), 3, warmup=1)
        nb = rdma.remote_axis_bytes(spec, ph, 1, 8, 4)
        per.append((ms, plain, nb))
        log(f"time remote_axis over the 8 resident endpoints {n}^3 r1 {ph.axis}: {ms:.4f} ms per "
            f"launch (plain {plain:.4f} ms, bound {bound_ms(nb, 0)[0]:.4f} ms by bytes, sector "
            f"floor {bound_ms(rdma.remote_axis_sector_bytes(spec, ph, 1, 8, 4), 0)[0]:.4f} ms)")
    k3 = len(per)
    timings["remote_axis_resident"] = dict(
        ms=sum(p[0] for p in per) / k3, plain_ms=sum(p[1] for p in per) / k3,
        bound=bound_ms(sum(p[2] for p in per) / k3, 0), library_ms=None)
    del t, pl, ends, pends

    # -- 8 blocks on 4 mesh positions: the endpoints span positions ------------------
    mesh4 = DeviceMesh((2, 2, 1), [dev] * 4)
    stacks = split_positions(base, spec, mesh4)
    ex4 = HaloExchange(spec, rd, mesh=mesh4)
    check(tuple(ex4.resident) == (1, 1, 2) and all(tuple(s.shape[:3]) == (2, 1, 1)
                                                   for s in stacks), "oversubscribed layout")
    reset()
    ex4({0: stacks})
    sync(dev)
    got = read()
    check(got["remote_axis"] == 3 * on_card and sum(got.values()) == got["remote_axis"],
          f"8 blocks on 4 positions: launches {got}")
    check(torch.equal(join_positions(stacks, spec), ref),
          "8 blocks on 4 positions != the resident exchange")
    ms4 = time_ms(lambda: ex4({0: stacks}), 10)
    timings["remote_axis_resident"]["extra"] = {"oversubscribed_exchange_ms": ms4,
                                                "resident_exchange_ms": timings["exchange_remote-dma"],
                                                "direct26_exchange_ms": timings["exchange_direct26"],
                                                "composed_exchange_ms": comp_ms}
    log(f"remote-dma exchange, 8 blocks of {n}^3 on 4 positions (2,2,1): == the resident "
        f"exchange on every cell; {ms4:.4f} ms, {nbytes / ms4 / 1e6:.2f} GB/s logical, "
        f"{ex4.last_transfer_count} slabs left a position; launches {got['remote_axis']}")
    del stacks, ex4, ex_r, remote, base, ref, t_c

    # -- direct26 steps: kernels vs plain versions vs the resident composed path -----
    gen.manual_seed(1510)
    g = torch.rand((n, n, n), generator=gen, device=dev, dtype=f64).to(f32)
    from stencil_tpu_torch.parallel import shard_blocks

    sel = sphere_sel_blocks(spec, dev)
    ranges = sk.block_sel_ranges(spec)
    outs = {}
    for label, ex in (("direct26", HaloExchange(spec, d26)), ("composed", HaloExchange(spec))):
        c = shard_blocks(g, spec, dev)
        out, _ = make_jacobi_loop(ex, steps)(c, torch.zeros_like(c), sel)
        outs[label] = unshard_blocks(out, spec)
    ex = HaloExchange(spec, d26)
    c = shard_blocks(g, spec, dev)
    nx_ = torch.zeros_like(c)
    for _ in range(steps):
        ex(c)
        c, nx_ = sk.sweep_plain(c, nx_, sel, spec, fst.NO_WRAP, ranges), c
    outs["plain"] = unshard_blocks(c, spec)
    check(np.array_equal(outs["direct26"], outs["plain"])
          and np.array_equal(outs["direct26"], outs["composed"]),
          f"jacobi {n}^3 (2,2,2) {steps} steps: direct26 != its plain versions or the composed path")
    log(f"jacobi {n}^3 (2,2,2) {steps} steps, direct26: == the plain versions == the resident "
        "axis-composed path")
    del g, c, nx_, outs

    # the stacked sweep of the direct26 step (no wrap, each block's sphere planes)
    st = rand_stack(spec, 1520)
    o15 = torch.zeros_like(st)
    s15 = sphere_sel_blocks(spec, dev)
    off = spec.compute_offset()
    rect = Rect3(off, off + spec.base)
    timings["jacobi_sweep_direct26"] = b1_times(
        time_ms, dev, lambda: sk.sweep(st, o15, s15, spec, fst.NO_WRAP, ranges),
        lambda: sk.sweep_plain(st, o15, s15, spec, fst.NO_WRAP, ranges),
        sk.sweep_bytes(spec, [rect], ranges))
    b1_log("jacobi_sweep_direct26", timings["jacobi_sweep_direct26"],
           f"{n}^3 (2,2,2) r1 stack, no wrap")
    a = sk.sweep(st, o15.clone(), s15, spec, fst.NO_WRAP, ranges)
    b = sk.sweep_plain(st, o15.clone(), s15, spec, fst.NO_WRAP, ranges)
    sync(dev)
    errs["jacobi_sweep_direct26"] = max_abs(a, b)
    check(torch.equal(a, b), "the direct26 stacked sweep: kernel != plain")
    del st, o15, s15, a, b

    # -- the main paths: jacobi3d over (2,2,2) with --direct26 and with remote-dma ----
    total = iters + chunk
    finals = {}
    for label, kw, per_step in (
            ("direct26", dict(device=dev, method=d26), {"jacobi_sweep": 1}),
            ("remote-dma", dict(device=dev, method=rd), {"jacobi_sweep": 1, "remote_axis": 3}),
            ("remote-dma, 8 blocks on 4 positions", dict(devices=[dev] * 4, method=rd),
             {"sweep_positions": 1, "remote_axis": 3})):
        reset()
        rv = jacobi3d.run(n, n, n, iters=iters, chunk=chunk, weak=False, partition=(2, 2, 2),
                          **kw)
        sync(dev)
        got = read()
        want = {name: total * per_step.get(name, 0) * on_card for name in counted}
        check(got == want, f"jacobi3d {n}^3 (2,2,2) {label}: launches {got}, expected {want}")
        check(rv["temporal_k"] == 0, f"jacobi3d {label}: multistep depth {rv['temporal_k']}")
        fin = finals[label] = rv["domain"].get_curr_global(rv["handle"])
        check(bool(np.isfinite(fin).all()) and float(fin.min()) >= 0.0
              and float(fin.max()) <= 1.0, f"jacobi3d {label}: field not finite or out of range")
        if label == "direct26":
            launches["jacobi_sweep_direct26"] = got["jacobi_sweep"]
        elif label == "remote-dma":
            launches["remote_axis_resident"] = got["remote_axis"]
        log(jacobi3d.csv_row(rv))
        log(f"jacobi3d {n}^3 over (2,2,2) residents ({label}): "
            f"{rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), {rv['mcells_per_s']:.1f} "
            f"Mcells/s, launches {dict((k, v) for k, v in got.items() if v)}")
        del rv, fin
    check(all(np.array_equal(f, finals["direct26"]) for f in finals.values()),
          "jacobi3d over (2,2,2): direct26, remote-dma and 4 positions end in different fields")
    log(f"jacobi3d {n}^3 over (2,2,2): direct26 == remote-dma == 8 blocks on 4 positions after "
        f"{total} steps")
    del finals

    # -- --multistep-rows: each tile height the kernel is built for ------------------
    heights = multistep_heights()
    one = GridSpec(Dim3(ms_n, ms_n, ms_n), Dim3(1, 1, 1), Radius.constant(1))
    # the planner's depth (32-row tiles) and the first deeper one (16-row)
    for k in (sk.MULTISTEP_KPLAN, sk.MULTISTEP_KLO + 1):
        rows = heights[(k, "float32")]
        check_multistep_rows(rows, k)
        c = rand_stack(one, 1530 + k)
        a = sk.multistep(c, torch.zeros_like(c), one, k)
        b = sk.multistep_plain(c, torch.zeros_like(c), one, k)
        sync(dev)
        check(torch.equal(a, b), f"multistep k={k} ({rows}-row tiles): kernel != plain")
        log(f"multistep_rows={rows} (k={k}, the kernel's tile height there): kernel == plain "
            f"multistep at {ms_n}^3")
        del c, a, b
    try:
        check_multistep_rows(16, 3)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None, "multistep_rows=16 at k=3 was not refused")
    log(f"multistep_rows=16 at k=3 refused: {refused[:90]}...")
    ex1 = HaloExchange(one)
    c = rand_stack(one, 1540)
    s1 = sphere_sel_blocks(one, dev)
    la = make_jacobi_loop(ex1, 6, multistep_rows=32)
    a, _ = la(c.clone(), torch.zeros_like(c), s1)
    b, _ = make_jacobi_loop(ex1, 6)(c.clone(), torch.zeros_like(c), s1)
    sync(dev)
    check(la.temporal_k == 3 and torch.equal(a, b),
          "the loop with multistep_rows=32 != the default loop")
    log(f"jacobi {ms_n}^3 6 steps with multistep_rows=32 (k=3): == the default loop")
    del c, s1, a, b

    # -- B9's uneven form at n^3 over 6 positions ----------------------------------
    spec6 = GridSpec(Dim3(n, n, n), Dim3(3, 2, 1), Radius.constant(4))
    mesh6 = DeviceMesh((3, 2, 1), [dev] * 6)
    ex6 = HaloExchange(spec6, rd, mesh=mesh6, persistent=True)
    ext = pst.position_extents(spec6, mesh6)
    check(not spec6.is_uniform() and len(set(ext)) > 1, "the 6-position split is not uneven")

    def rand_pos(seed, dtype=f32):
        gen.manual_seed(seed)
        p = spec6.padded()
        if dtype == torch.int32:
            return [torch.randint(-1, 4, (1, 1, 1, p.z, p.y, p.x), generator=gen, device=dev,
                                  dtype=dtype) for _ in range(6)]
        return [torch.rand((1, 1, 1, p.z, p.y, p.x), generator=gen, device=dev, dtype=f64)
                .to(dtype) for _ in range(6)]

    errs["persistent_jacobi_mesh_uneven"] = 0.0
    for k in (4, 3):
        c, nx_, s = rand_pos(1550 + k), rand_pos(1560 + k), rand_pos(1570 + k, torch.int32)
        ex6(c)
        ex6(s)
        pc, pn, ps = [b.clone() for b in c], [b.clone() for b in nx_], [b.clone() for b in s]
        reset()
        pst.persistent_jacobi_mesh(c, nx_, s, spec6, k, mesh6)
        check(pst.persistent_jacobi_mesh.uneven == on_card, "the uneven form did not launch")
        pst.persistent_jacobi_mesh_plain(pc, pn, ps, spec6, k, mesh6)
        sync(dev)
        errs["persistent_jacobi_mesh_uneven"] = max(
            errs["persistent_jacobi_mesh_uneven"],
            max(max_abs(x, y) for x, y in zip(c + nx_, pc + pn)))
        check(all(torch.equal(x, y) for x, y in zip(c + nx_ + s, pc + pn + ps)),
              f"persistent_jacobi_mesh uneven {n}^3 (3,2,1) k={k}: kernel != plain")
        log(f"persistent_jacobi_mesh uneven {n}^3 (3,2,1) k={k}: == plain (both buffers and sel "
            "of every position)")
        if k == 4:
            grown = sum((x + 2 * gg) * (y + 2 * gg) * (z + 2 * gg) for z, y, x in ext
                        for gg in range(k))
            nb = sum(pst.chunk_bytes(spec6, k, (x, y, z)) for z, y, x in ext)
            timings["persistent_jacobi_mesh_uneven"] = dict(
                ms=time_ms(lambda: pst.persistent_jacobi_mesh(c, nx_, s, spec6, 4, mesh6), 10),
                plain_ms=time_ms(lambda: pst.persistent_jacobi_mesh_plain(c, nx_, s, spec6, 4,
                                                                          mesh6), 1, warmup=1),
                bound=bound_ms(nb, 6 * grown), library_ms=None,
                extra={"deep_exchange_ms": time_ms(lambda: ex6(c), 10)})
        del c, nx_, s, pc, pn, ps
    t = timings["persistent_jacobi_mesh_uneven"]
    log(f"time persistent_jacobi_mesh uneven {n}^3 (3,2,1) k=4: {t['ms']:.4f} ms per launch "
        f"(plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by {t['bound'][1]}); the "
        f"deep exchange before it {t['extra']['deep_exchange_ms']:.4f} ms")

    # steps steps over the 6 positions (k=4) against the single-block default path
    gen.manual_seed(1580)
    g = torch.rand((n, n, n), generator=gen, device=dev, dtype=f64).to(f32)
    one1 = GridSpec(Dim3(n, n, n), Dim3(1, 1, 1), Radius.constant(1))
    c1 = shard_blocks(g, one1, dev)
    ref1, _ = make_jacobi_loop(HaloExchange(one1), steps)(c1, torch.zeros_like(c1),
                                                          sphere_sel_blocks(one1, dev))
    ref1 = unshard_blocks(ref1, one1)
    c6 = shard_blocks(g, spec6, mesh6)
    out6, _ = make_jacobi_loop(ex6, steps, temporal_k=4)(c6, [torch.zeros_like(b) for b in c6],
                                                         sphere_sel_blocks(spec6, mesh6))
    check(np.array_equal(unshard_blocks(out6, spec6), ref1),
          f"jacobi {n}^3 {steps} steps over 6 positions, persistent k=4 != the single-block "
          "default path")
    log(f"jacobi {n}^3 {steps} steps over 6 positions, persistent (uneven form, k=4): == the "
        "single-block default path")
    del g, c1, ref1, c6, out6

    # the main path: jacobi3d over 6 positions with the persistent variant
    reset()
    rv = jacobi3d.run(n, n, n, devices=[dev] * 6, method=rd, iters=pers_iters, chunk=pers_chunk,
                      weak=False, kernel_variant="persistent", deep_halo=4)
    sync(dev)
    got = read()
    chunks = (pers_iters + pers_chunk) // 4
    calls = (pers_iters + pers_chunk) // pers_chunk
    want = {name: 0 for name in counted}
    want.update({"persistent_jacobi_mesh": chunks * on_card,
                 "remote_axis": 2 * (chunks + calls) * on_card,
                 "self_fill": (chunks + calls) * on_card})
    check(got == want and pst.persistent_jacobi_mesh.uneven == chunks * on_card,
          f"jacobi3d persistent over 6 positions: launches {got}, expected {want}")
    lpc = rv["domain"].halo_exchange.last_launches_per_chunk
    check(lpc == 2, f"jacobi3d persistent over 6 positions: {lpc} launches per chunk, not 2")
    fin = rv["domain"].get_curr_global(rv["handle"])
    check(bool(np.isfinite(fin).all()) and float(fin.min()) >= 0.0 and float(fin.max()) <= 1.0,
          "jacobi3d persistent over 6 positions: field not finite or out of range")
    launches["persistent_jacobi_mesh_uneven"] = got["persistent_jacobi_mesh"]
    timings["persistent_jacobi_mesh_uneven"]["extra"]["ms_per_iter"] = rv["iter_trimean_s"] * 1e3
    log(jacobi3d.csv_row(rv))
    log(f"jacobi3d {n}^3 over 6 positions (3,2,1), persistent k=4 (uneven form): "
        f"{rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), {rv['mcells_per_s']:.1f} "
        f"Mcells/s, launches {dict((k, v) for k, v in got.items() if v)}, {lpc} a chunk")
    del rv, fin, ex6
    return timings, launches, errs


def tenants_phase(dev, time_ms, tenants: int = 64, edge: int = 32, big=(8, 128),
                  ragged=(5, (33, 13, 7)), many=(300, (6, 5, 4)), steps: int = 6,
                  chunk: int = 3, serve_edges=(32, 64), serve_steps: int = 8,
                  timed: bool = True):
    """Phase 16, the serving path on ``dev``: Astaroth tenants on B5's and
    B4's tenant forms, the Astaroth campaign, and the serving daemon.

    - B5's tenant form (``substep_tasks`` over ``tenant_tasks``: one task a
      tenant of a ``(B, pz, py, px)`` stack, one launch a stage) against its
      plain version with torch.equal, fp64 and fp32, stages 0-2, random
      fields at dt 0.1: ``tenants`` of ``edge``^3 (tensor copies in fp64),
      the ragged tenants (an odd x pitch: every task on cp.async) and more
      tenants than one launch's table holds (two launches a stage). Each
      lane of the tenant launch also equals the same tenant through the
      one-block launch (``substep``).
    - B4's tenant form (``wrap_fill_tenants``: x, y, z over the 8 fields,
      one launch an axis, z wrapping each tenant onto itself) against
      ``wrap_fill_batched`` with torch.equal at ``tenants`` x ``edge``^3
      fp64 and fp32 and the ragged tenants.
    - Timed (``timed``): B5's tenant launch on the campaign's stage mix and
      B4's tenant fill per axis, each beside its bytes bound and its plain
      version.
    - ``apps.campaign`` with ``--workload astaroth --mode batched`` at
      ``tenants`` x ``edge``^3 and ``big`` fp64, ``steps`` steps in chunks
      of ``chunk``, tenant t1 faulted every time from step 3 (evicted, the
      others retire); launch counts set to 0 just before and read just
      after: 3 fills and 3 substep launches (one per 256 tenants) an
      iteration, the iterations counted as the driver runs them. Every
      retired tenant equals the same tenant stepped alone through the
      tenant form with B = 1, byte for byte.
    - The serving daemon in process: a first wave of jobs (jacobi
      ``serve_edges`` fp32 in two buckets, astaroth ``edge``^3 fp64, mixed
      priorities, one owner over its quota, one deadline that the seeded
      ledger prices infeasible) dropped before ``serve()``, a second wave of
      the running slot's bucket dropped from its first chunk boundary,
      elastic widths 1..8 so that the running slot grows; every job retires
      with ``results/<job>.json``, its final field byte-equal to the batch
      ``CampaignDriver``'s; every record valid under the port's schema.
      Then a daemon drained after its first retirement and a second one
      revived on its directory: no retired job re-run, every result
      byte-equal to the uninterrupted serve's.

    Sizes are arguments so that the phase can be rehearsed on the CPU (where
    the plain versions count no launch). Returns ``(timings, launches,
    errs)`` keyed ``astaroth_substep_tenants`` and ``self_fill_tenants``."""
    import stencil_tpu_torch.astaroth.integrate as integ
    from stencil_tpu_torch import GridSpec
    from stencil_tpu_torch.apps import campaign as campaign_app
    from stencil_tpu_torch.astaroth.equations import Constants
    from stencil_tpu_torch.astaroth.integrate import FIELDS, inv_ds_of
    from stencil_tpu_torch.campaign import CampaignDriver, TenantJob, astaroth_init_state
    from stencil_tpu_torch.campaign.driver import WORKLOADS
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.obs import ledger as ledger_mod
    from stencil_tpu_torch.obs import telemetry
    from stencil_tpu_torch.ops import astaroth_substep as asub
    from stencil_tpu_torch.ops import halo_fill
    from stencil_tpu_torch.serve import ServeScheduler, job_from_doc
    from stencil_tpu_torch.serve.admission import LEDGER_METRIC, bucket_label
    from stencil_tpu_torch.utils.roofline import bound_ms

    on_card = dev.type == "cuda"  # the plain versions (a CPU rehearsal) count no launch
    gen = torch.Generator(device=dev)
    names = ("astaroth_substep_tenants", "self_fill_tenants")
    errs = {name: 0.0 for name in names}
    timings, launches = {}, {}

    def spec_of(size):
        return GridSpec(Dim3(*size), Dim3(1, 1, 1), Radius.constant(3), aligned=False)

    def info_of(spec):
        return WORKLOADS["astaroth"]._info(spec)

    def rand8(spec, b, seed, dtype):
        p = spec.padded()
        out = []
        for f in range(8):
            gen.manual_seed(seed + f)
            out.append(torch.rand((b, p.z, p.y, p.x), generator=gen, device=dev,
                                  dtype=dtype) * 0.1)
        return out

    # -- B5's tenant form against its plain version and the one-block launch ------------
    def held_substep(label, size, b, dtype, one_block):
        spec = spec_of(size)
        ainfo = info_of(spec)
        consts, ids = Constants.from_info(ainfo), inv_ds_of(ainfo)
        tasks = asub.tenant_tasks(spec, b)
        curr8, out0 = rand8(spec, b, 1900, dtype), rand8(spec, b, 2000, dtype)
        ok, op = [t.clone() for t in out0], [t.clone() for t in out0]
        before = asub.substep_tasks.launches
        for s in (0, 1, 2):
            asub.substep_tasks(curr8, ok, spec, tasks, consts, ids, s, 0.1)
            asub.substep_tasks_plain(curr8, op, spec, tasks, consts, ids, s, 0.1)
        sync(dev)
        launched = asub.substep_tasks.launches - before
        want = 3 * -(-b // asub.MAX_TASKS) * on_card
        check(launched == want, f"B5 tenants {label}: {launched} launches, expected {want}")
        errs[names[0]] = max(errs[names[0]], *(max_abs(a, c) for a, c in zip(ok, op)))
        check(all(torch.equal(a, c) for a, c in zip(ok, op)),
              f"B5 tenants {label}: kernel != plain version (max abs err {errs[names[0]]:.3e})")
        item = torch.empty((), dtype=dtype).element_size()
        tma = sum(r[-1] for r in asub.substep_table(tasks, spec, 132, item)[0])
        if one_block:
            for j in range(b):
                o1 = [t[j].clone() for t in out0]
                for s in (0, 1, 2):
                    asub.substep([t[j] for t in curr8], o1, spec, consts, ids, s, 0.1)
                check(all(torch.equal(a[j], c) for a, c in zip(ok, o1)),
                      f"B5 tenants {label}: lane {j} != the one-block launch of that tenant")
        log(f"astaroth_substep tenants {label} {str(dtype)[6:]} stages 0-2: {b} tasks ({tma} by "
            f"tensor copies) in {launched} launch(es), equal to the plain version"
            + (f" and, lane by lane, to {b} one-block launches" if one_block else ""))

    rb, rsize = ragged
    mb, msize = many
    for dtype in (torch.float64, torch.float32):
        held_substep(f"{tenants} x {edge}^3", (edge,) * 3, tenants, dtype, True)
        held_substep(f"{rb} x {'x'.join(map(str, rsize))}", rsize, rb, dtype, True)
        held_substep(f"{mb} x {'x'.join(map(str, msize))}", msize, mb, dtype, False)

    # -- B4's tenant form against wrap_fill_batched -------------------------------------
    def held_fill(label, size, b, dtype):
        spec = spec_of(size)
        fields = rand8(spec, b, 2100, dtype)  # halos random too
        want = [t.clone() for t in fields]
        before = halo_fill.self_fill.launches
        halo_fill.wrap_fill_tenants(spec, fields)
        for t in want:
            halo_fill.wrap_fill_batched(spec, t)
        sync(dev)
        launched = halo_fill.self_fill.launches - before
        check(launched == 3 * on_card, f"B4 tenants {label}: {launched} launches, expected 3")
        errs[names[1]] = max(errs[names[1]], *(max_abs(a, c) for a, c in zip(fields, want)))
        check(all(torch.equal(a, c) for a, c in zip(fields, want)),
              f"B4 tenants {label}: kernel != wrap_fill_batched")
        log(f"self_fill tenants {label} {str(dtype)[6:]}: x, y, z over 8 fields in {launched} "
            "launches, equal to wrap_fill_batched")

    for dtype in (torch.float64, torch.float32):
        held_fill(f"{tenants} x {edge}^3", (edge,) * 3, tenants, dtype)
    held_fill(f"{rb} x {'x'.join(map(str, rsize))}", rsize, rb, torch.float64)

    # -- timed: B5's tenant launch on the stage mix and B4's tenant fill per axis -------
    if timed:
        spec = spec_of((edge,) * 3)
        ainfo = info_of(spec)
        consts, ids = Constants.from_info(ainfo), inv_ds_of(ainfo)
        tasks = asub.tenant_tasks(spec, tenants)
        cells = tenants * edge ** 3
        for dtype in (torch.float64, torch.float32):
            item = torch.empty((), dtype=dtype).element_size()
            curr8, out8 = rand8(spec, tenants, 2200, dtype), rand8(spec, tenants, 2300, dtype)

            def run(s):
                return lambda: asub.substep_tasks(curr8, out8, spec, tasks, consts, ids, s, 1e-8)

            def plain(s):
                return lambda: asub.substep_tasks_plain(curr8, out8, spec, tasks, consts, ids, s,
                                                        1e-8)

            st = [time_ms(run(s), 10, warmup=1, graph=True) for s in (0, 1)]
            pl = [time_ms(plain(s), 1, warmup=0) for s in (0, 1)]
            nbytes = (asub.tasks_bytes(tasks, item, 0) + 2 * asub.tasks_bytes(tasks, item, 1)) / 3
            flops = (asub.FLOPS_PER_CELL[0] + 2 * asub.FLOPS_PER_CELL[1]) / 3 * cells
            t = dict(ms=(st[0] + 2 * st[1]) / 3, plain_ms=(pl[0] + 2 * pl[1]) / 3,
                     bound=bound_ms(nbytes, flops, dtype), library_ms=None)
            log(f"time astaroth_substep_tenants {tenants} x {edge}^3 {str(dtype)[6:]}: "
                f"{t['ms']:.4f} ms per launch on the campaign's mix (stage 0 {st[0]:.4f}, stages "
                f"1-2 {st[1]:.4f}; plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by "
                f"{t['bound'][1]}; {t['ms'] / t['bound'][0]:.2f}x)")
            if dtype == torch.float64:
                timings[names[0]] = t
            del curr8, out8
        fields = rand8(spec, tenants, 2400, torch.float64)
        per, plain_per, nb = {}, {}, {}
        for axis in halo_fill.AXIS_ORDER:
            per[axis] = time_ms(lambda: halo_fill.self_fill(fields, spec, axis, z_stack=tenants,
                                                            tenants=True), 20, warmup=2,
                                graph=True)
            plain_per[axis] = time_ms(lambda: halo_fill.self_fill_plain(fields, spec, axis), 1,
                                      warmup=0)
            nb[axis] = 8 * tenants * halo_fill.fill_bytes(spec, axis, 8)
        mean = lambda d: sum(d.values()) / 3  # noqa: E731
        timings[names[1]] = dict(ms=mean(per), plain_ms=mean(plain_per),
                                 bound=bound_ms(mean(nb), 0), library_ms=None)
        t = timings[names[1]]
        log(f"time self_fill_tenants {tenants} x {edge}^3 r3 8 fp64 fields: {t['ms']:.4f} ms per "
            f"launch, mean of x {per['x']:.4f} / y {per['y']:.4f} / z {per['z']:.4f} (plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by {t['bound'][1]}, "
            f"{mean(nb) / 1e6:.1f} MB an axis read and written)")
        del fields

    # -- the Astaroth campaign through apps.campaign ------------------------------------
    made = integ.make_batched_astaroth_step
    iterations = [0]

    def counting(spec, info, dt=1e-8, iters=1, device=None):
        fn = made(spec, info, dt=dt, iters=iters, device=device)

        def run(curr, out):
            iterations[0] += iters
            return fn(curr, out)

        return run

    def campaign_run(b, e):
        spec = spec_of((e,) * 3)
        argv = ["--workload", "astaroth", "--mode", "batched", "--tenants", str(b), "--slot",
                str(b), "--size", str(e), "--steps", str(steps), "--chunk", str(chunk),
                "--dtype", "float64", "--device", str(dev), "--inject",
                "nan@3:tenant=t1:repeat=always", "--max-rollbacks", "1", "--rollback-backoff",
                "0"]
        with tempfile.TemporaryDirectory(prefix="chip-smoke-astaroth-campaign-") as d:
            args = campaign_app.parse_args(argv + ["--campaign-dir", d])
            campaign_app.build_kernels(args.device)
            iterations[0] = 0
            asub.substep_tasks.launches = 0
            halo_fill.self_fill.launches = 0
            integ.make_batched_astaroth_step = counting
            try:
                out = campaign_app.run_modes(args, d)
            finally:
                integ.make_batched_astaroth_step = made
            sync(dev)
            got = (asub.substep_tasks.launches, halo_fill.self_fill.launches)
        want = (3 * iterations[0] * -(-b // asub.MAX_TASKS) * on_card, 3 * iterations[0] * on_card)
        check(iterations[0] >= steps and got == want,
              f"astaroth campaign {b} x {e}^3: launches (substep, fill) {got}, expected {want} "
              f"for {iterations[0]} iterations")
        res = out["_batched"]["results"]
        check(out["evicted"] == ["t1"] and len(res) == b
              and all(r.outcome == "done" and r.steps == steps for t, r in res.items()
                      if t != "t1"),
              f"astaroth campaign {b} x {e}^3: evicted {out['evicted']}, outcomes "
              f"{sorted({r.outcome for r in res.values()})}")
        # each retired tenant against the same tenant stepped alone (B = 1)
        alone = made(spec, info_of(spec), dt=WORKLOADS["astaroth"].dt, iters=steps, device=dev)
        p, off = spec.padded(), spec.compute_offset()
        inner = (0, slice(off.z, off.z + e), slice(off.y, off.y + e), slice(off.x, off.x + e))
        for i in range(b):
            tid = f"t{i}"
            if tid == "t1":
                continue
            job = TenantJob(tid, (e, e, e), steps, "float64", seed=i, workload="astaroth")
            curr = {}
            for k, a in astaroth_init_state(job).items():
                t = torch.zeros((1, p.z, p.y, p.x), dtype=torch.float64, device=dev)
                t[inner] = torch.from_numpy(a).to(dev)
                curr[k] = t
            curr, _ = alone(curr, {k: torch.zeros_like(t) for k, t in curr.items()})
            for k in FIELDS:
                check(np.array_equal(curr[k][inner].cpu().numpy(), res[tid].finals[k]),
                      f"astaroth campaign {b} x {e}^3: tenant {tid} {k} != the tenant alone")
        log(f"astaroth campaign {b} x {e}^3 fp64, {steps} steps in chunks of {chunk}, t1 faulted "
            f"from step 3: t1 evicted, {b - 1} retired, each byte-equal to its tenant stepped "
            f"alone; {iterations[0]} iterations, launches (substep, fill) {got}; "
            f"{out['batched_mcells_per_s']:.1f} tenant Mcells/s, step p50 "
            f"{out['batched_p50_step_s'] * 1e3:.4f} ms, p99 {out['batched_p99_step_s'] * 1e3:.4f} "
            f"ms")
        return got

    got = campaign_run(tenants, edge)
    launches[names[0]], launches[names[1]] = got
    campaign_run(*big)

    # -- the serving daemon ----------------------------------------------------------------
    def doc(jid, size, workload="jacobi", dtype="float32", priority="normal", tenant=None,
            deadline_ms=None, seed=0):
        d = {"job": jid, "size": size, "steps": serve_steps, "workload": workload,
             "dtype": dtype, "priority": priority, "seed": seed}
        if tenant:
            d["tenant"] = tenant
        if deadline_ms is not None:
            d["deadline_ms"] = deadline_ms
        return d

    def drop(sdir, d):
        inc = os.path.join(sdir, "jobs", "incoming")
        os.makedirs(inc, exist_ok=True)
        tmp = os.path.join(inc, f".tmp-{d['job']}.json")
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, os.path.join(inc, f"{d['job']}.json"))

    e0, e1 = serve_edges
    first = [doc("j0", e0, priority="high", seed=1), doc("j1", e0, seed=2),
             doc("k0", e1, priority="low", seed=3), doc("k1", e1, priority="high", seed=4),
             doc("a0", edge, "astaroth", "float64", seed=5),
             doc("a1", edge, "astaroth", "float64", priority="low", seed=6),
             doc("b0", e0, tenant="bob", seed=7), doc("b1", e1, tenant="bob", seed=8),
             doc("b2", e0, tenant="bob", priority="low", seed=9),
             doc("late-bound", e0, deadline_ms=1e-3, seed=10)]
    buckets = {(e0, "float32", "jacobi"), (e1, "float32", "jacobi"),
               (edge, "float64", "astaroth")}

    class Serve(ServeScheduler):
        """Drops the second wave (the running slot's bucket) at its first
        chunk boundary."""

        def __init__(self, *a, late=0, **kw):
            super().__init__(*a, **kw)
            self._late = late

        def _observe_chunk(self, bucket, per, done_now):
            (size, dtype, workload) = bucket
            for i in range(self._late):
                drop(self.serve_dir, doc(f"late{i}", size[0], workload, dtype, seed=20 + i))
            self._late = 0
            super()._observe_chunk(bucket, per, done_now)

    class DrainMidRun(ServeScheduler):
        """Requests a drain at the first chunk boundary after its first
        retirement: the running slot parks mid-trajectory."""

        def _observe_chunk(self, bucket, per, done_now):
            super()._observe_chunk(bucket, per, done_now)
            if self._retired_run:
                self.request_drain("smoke")

    kw = dict(device=dev, chunk=2, max_idle_s=0.5, max_wall_s=60.0, poll_s=0.02,
              slot_min=1, slot_max=8, packing=True, fairness=True, preempt=True)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-serve-") as d:
        sdir, lpath, metrics = (os.path.join(d, n) for n in ("s", "ledger.jsonl", "m.jsonl"))
        # the deadline pricing and the resize's priced remaining wall: 50 ms
        # a step in every bucket, from a ledger this phase writes
        ledger_mod.append_entries(lpath, [ledger_mod.make_entry(
            LEDGER_METRIC, 50.0, label="seed", unit="ms", platform=dev.type, source="serve",
            config={"bucket": bucket_label(((s,) * 3, dt, wl))},
            detail={"bucket": bucket_label(((s,) * 3, dt, wl)), "samples": 8})
            for s, dt, wl in sorted(buckets)])
        for dd in first:
            drop(sdir, dd)
        telemetry.configure(metrics_out=metrics, app="chip-smoke-serve")
        t0 = time.perf_counter()
        try:
            out = Serve(sdir, 2, late=4, quota=2, admission_ledger=lpath, **kw).serve()
        finally:
            telemetry.get().close()
        wall = time.perf_counter() - t0
        recs = [json.loads(ln) for ln in open(metrics) if ln.strip()]
        bad = [e for r in recs for e in telemetry.validate_record(r)]
        check(not bad, f"serve: invalid telemetry records {bad[:3]}")
        count = lambda name: sum(r["name"] == name for r in recs)  # noqa: E731
        served = {dd["job"] for dd in first if dd["job"] != "late-bound"} | {
            f"late{i}" for i in range(4)}
        check(out["retired"] == len(served) and out["rejected"] == 1 and out["deferred"] >= 1
              and out["resizes"] >= 1 and out["backfills"] >= 0 and count("serve.resized") >= 1,
              f"serve: {({k: out[k] for k in ('retired', 'rejected', 'deferred', 'resizes')})}")
        results = out["results"]
        for jid in sorted(served):
            with open(os.path.join(sdir, "results", f"{jid}.json")) as f:
                rdoc = json.load(f)
            check(rdoc["outcome"] == "done" and rdoc["steps"] == serve_steps
                  and results[jid].outcome == "done", f"serve: job {jid} result {rdoc}")
        # every result against the batch driver on the same jobs
        specs = {}
        for name in sorted(os.listdir(os.path.join(sdir, "jobs", "claimed"))):
            with open(os.path.join(sdir, "jobs", "claimed", name)) as f:
                specs[name[:-5]] = json.load(f)
        jobs = [job_from_doc(specs[j], i) for i, j in enumerate(sorted(served))]
        batch = CampaignDriver(jobs, 4, os.path.join(d, "batch"), device=dev, chunk=2).run()
        for jid in sorted(served):
            a, c = results[jid].finals, batch["results"][jid].finals
            check(sorted(a) == sorted(c) and all(a[k].tobytes() == c[k].tobytes() for k in a),
                  f"serve: job {jid} != the batch CampaignDriver's")
        log(f"serve in process: {out['retired']} jobs retired in {wall:.2f} s "
            f"({out['retired'] / wall:.3f} jobs/s; {out['slots']} slots), admitted "
            f"{out['admitted']}, deferred {out['deferred']}, rejected {out['rejected']}, "
            f"backfills {out['backfills']}, resizes {out['resizes']} "
            f"({[(r['from_width'], r['to_width'], r['reason']) for r in recs if r['name'] == 'serve.resized']}), "
            f"preemptions {out['preemptions']}; records: "
            + ", ".join(f"{n} {count(n)}" for n in sorted({r['name'] for r in recs
                                                          if r['name'].startswith('serve.')}))
            + "; every result byte-equal to the batch driver's")

        # drain after the first retirement, then revive on the same directory
        rdir = os.path.join(d, "r")
        for dd in first[:6]:
            drop(rdir, dd)
        out1 = DrainMidRun(rdir, 2, **kw).serve()
        with open(os.path.join(rdir, "serve-state.json")) as f:
            parked = sorted(j for j, st in json.load(f)["jobs"].items()
                            if st["state"] == "queued" and st["steps_done"] > 0)
        out2 = ServeScheduler(rdir, 2, **kw).serve()
        done1 = {t for t, r in out1["results"].items() if r.outcome == "done"}
        done2 = {t for t, r in out2["results"].items() if r.outcome == "done"}
        want = {dd["job"] for dd in first[:6]}
        check(out1["outcome"] == "drained" and done1 and parked and not done1 & done2
              and done1 | done2 == want and out2["revived"] == len(want) - len(done1),
              f"serve drain/revive: first {sorted(done1)}, revived {out2['revived']} and "
              f"retired {sorted(done2)}")
        for jid in sorted(want):
            a = (out1 if jid in done1 else out2)["results"][jid].finals
            c = results[jid].finals
            check(all(a[k].tobytes() == c[k].tobytes() for k in c),
                  f"serve drain/revive: job {jid} != the uninterrupted serve's")
        log(f"serve drained mid-run after retiring {sorted(done1)} ({parked} parked "
            f"mid-trajectory), a second daemon revived {out2['revived']} job(s) and retired "
            f"{sorted(done2)}: none re-run, every result byte-equal to the uninterrupted serve's")
    return timings, launches, errs


# the one-stack instantiations' registers at stage 0 and stages 1-2, as the
# task-table form was built, which the positions form's own instantiation
# leaves as they were
SUBSTEP_REGS = {(8, 0): 157, (8, 1): 168, (4, 0): 77, (4, 1): 80}
# (2,2,2) x 256^3 fp64 over resident blocks, the overlap iteration and the
# table launch on the main path's mix (PERF.md, the resident rows; NVIDIA H100
# 80GB HBM3, 700 W)
RESIDENT_ITER_MS, RESIDENT_TABLE_MS = 55.6269, 15.6474


def astaroth_mesh_phase(dev, time_ms, n: int = 256, mid: int = 128, iters: int = 3,
                        app_iters: int = 6, small=(67, 45, 29), many=(60, 40, 28),
                        timed: bool = True):
    """Phase 17, Astaroth over a mesh of block positions on ``dev`` (every
    position on the one card, each position's stacks their own
    allocations): B5's positions form (``substep_positions``,
    csrc/astaroth_substep.cu) and the step, the fused loop and the app
    over the mesh.

    - The instantiations' registers, spill and blocks per SM: the one-stack
      form's held to the task table's (fp64 157 / 168, fp32 77 / 80, no
      spill), the positions form's with no spill.
    - The positions form against its plain version with torch.equal, stages
      0-2 and the shells at stage 0, from random fields (halos and pad
      included) at dt 0.1: 8 positions of ``mid``^3 fp64 (tensor copies)
      and fp32; the uneven ``small`` over (2,2,2) (odd extents) in fp32 and
      in fp64 with one position's fields one cell off 16-byte alignment
      (its tasks on cp.async, the others' on tensor copies); 12 positions
      of ``many`` over (3,2,2), above the 8 one launch takes (2 launches a
      stage); (2,2,2) blocks on 2 positions (4 residents each); and the
      main path's 8 positions of ``n``^3 fp64 at stages 0-1 and the
      shells, each plain pass timed.
    - The step over the mesh against the same step over the resident blocks
      of one stack, torch.equal on every compute cell after ``iters``
      iterations (the same kernel arithmetic, and exchanges that copy
      bits): (2,2,2) x ``mid``^3 fp64 with overlap and without, the mixed
      (1,1,2) over 2 positions (x and y wrap by B4), (2,2,2) blocks on 4
      positions, the uneven ``small``; and ``make_fused_astaroth_loop`` (B7
      over the 8 fields) against the composed mesh step. Launches counted
      around each: with overlap 4 positions launches an iteration (one of
      them the shells), without 3; B6's phases (3 an exchange on (2,2,2),
      1 on (1,1,2) beside 2 B4 fills), B7 once an iteration in the fused
      loop; no one-stack launch.
    - One exchange of 8 fp64 fields, against the resident exchange of the
      same stacks on every compute and halo cell, launches counted and
      timed: B6 over (2,2,2) x ``n``^3 on 8 positions, B7 (the fused
      exchange) on the same, and the mixed (1,1,2) x ``n``^3 on 2
      positions (B6 on z, B4 on x and y).
    - ``apps.astaroth.run(devices=[dev] * 8, method=REMOTE_DMA)`` at the
      conf's ``n``^3 a position in fp64, with overlap and without; launch
      counts set to 0 just before and read just after each.
    - Timed (``timed``): the positions launch over 8 x ``n``^3 fp64 on the
      main path's stage mix and its 48-shell launch, each beside its bound
      and plain version, and the resident table launch over the same cells
      in the same call.

    Sizes are arguments so that the phase can be rehearsed on the CPU (where
    the plain versions count no launch). Returns ``(timings, launches,
    errs)`` keyed ``astaroth_substep_positions`` and
    ``astaroth_substep_positions_shells``."""
    from stencil_tpu_torch import GridSpec
    from stencil_tpu_torch.apps import astaroth as astaroth_app
    from stencil_tpu_torch.astaroth.equations import Constants
    from stencil_tpu_torch.astaroth.integrate import (FIELDS, inv_ds_of, make_astaroth_step,
                                                      make_fused_astaroth_loop)
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import astaroth_substep as asub
    from stencil_tpu_torch.ops import fused_stencil, halo_fill, remote_dma
    from stencil_tpu_torch.astaroth.reductions import compute_mask
    from stencil_tpu_torch.parallel import (DeviceMesh, HaloExchange, Method, join_positions,
                                            split_positions)
    from stencil_tpu_torch.utils.roofline import bound_ms

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"  # the plain versions (a CPU rehearsal) count no launch
    gen = torch.Generator(device=dev)
    ainfo = astaroth_app.load()
    consts, ids = Constants.from_info(ainfo), inv_ds_of(ainfo)
    names = ("astaroth_substep_positions", "astaroth_substep_positions_shells")
    errs = {name: 0.0 for name in names}
    timings, launches = {}, {}

    def spec_of(size, part):
        return GridSpec(Dim3(*size), Dim3(*part), Radius.constant(3))

    # -- the instantiations ---------------------------------------------------------
    if on_card:
        for item, tname in ((8, "fp64"), (4, "fp32")):
            for stage in (0, 1):
                one = asub.substep_info(dev.index, item, stage)
                pos = asub.substep_info(dev.index, item, stage, positions=True)
                check(one["regs"] == SUBSTEP_REGS[item, stage] and one["local_bytes"] == 0,
                      f"astaroth_substep {tname} stage {stage}: {one}, not "
                      f"{SUBSTEP_REGS[item, stage]} registers and no spill")
                check(pos["local_bytes"] == 0 and pos["blocks_per_sm"] == one["blocks_per_sm"],
                      f"astaroth_substep positions {tname} stage {stage} spills or loses a "
                      f"block: {pos}")
                log(f"astaroth_substep {tname} stage {'0' if stage == 0 else '1-2'}: one stack "
                    f"{one['regs']} registers, positions form {pos['regs']} registers, "
                    f"{pos['local_bytes']} bytes of spill, {pos['blocks_per_sm']} block(s) "
                    f"per SM")

    def stacks(spec, resident, seed, dtype, off_pos=()):
        """8 lists of one random ``resident`` stack per position (scaled to
        [0, 0.1)), each its own allocation; the positions in ``off_pos`` one
        cell off 16-byte alignment."""
        r, p = Dim3.of(resident), spec.padded()
        shape = (r.z, r.y, r.x, p.z, p.y, p.x)
        npos = asub.position_mesh(spec, r).flatten()
        out = []
        for f in range(8):
            per = []
            for q in range(npos):
                gen.manual_seed(seed + 97 * f + q)
                off = int(q in off_pos)
                flat = torch.rand(int(np.prod(shape)) + off, generator=gen, device=dev,
                                  dtype=dtype) * 0.1
                per.append(flat[off:].view(shape))
            out.append(per)
        return out

    def held(name, label, spec, resident, tasks, dtype, stages, want, off_pos=(),
             time_plain=None):
        """``stages`` through the kernel and through the plain version from
        the same out stacks, torch.equal on every cell, ``want`` launches a
        stage; with ``time_plain`` (the timer) each plain pass is timed;
        returns the plain ms by stage."""
        curr8 = stacks(spec, resident, 1700, dtype, off_pos)
        ok = stacks(spec, resident, 1800, dtype, off_pos)
        op = stacks(spec, resident, 1800, dtype, off_pos)
        before, plain_ms = asub.substep_positions.launches, {}
        for s in stages:
            asub.substep_positions(curr8, ok, spec, tasks, consts, ids, s, 0.1)

            def plain(s=s):
                asub.substep_positions_plain(curr8, op, spec, tasks, consts, ids, s, 0.1)

            if time_plain is None:
                plain()
            else:
                plain_ms[s] = time_plain(plain, 1, warmup=0)
        sync(dev)
        launched = asub.substep_positions.launches - before
        check(launched == len(stages) * want * on_card,
              f"{name} {label}: {launched} launches, expected {len(stages) * want * on_card}")
        pairs = [(a, b) for fa, fb in zip(ok, op) for a, b in zip(fa, fb)]
        errs[name] = max(errs[name], *(max_abs(a, b) for a, b in pairs))
        check(all(torch.equal(a, b) for a, b in pairs),
              f"{name} {label}: kernel != plain version (max abs err {errs[name]:.3e})")
        item = torch.empty((), dtype=dtype).element_size()
        aligned = [all(f[q].data_ptr() % 16 == 0 for f in curr8) for q in range(len(curr8[0]))]
        rows, _ = asub.position_table(tasks, spec, 132, item, aligned)
        log(f"{name} {label} {str(dtype)[6:]} stages {list(stages)}: {len(tasks)} tasks over "
            f"{len(curr8[0])} positions ({sum(r[-2] for r in rows)} by tensor copies) in "
            f"{launched} launch(es), equal")
        del curr8, ok, op
        return plain_ms

    # -- the positions form against its plain version ------------------------------
    one = Dim3(1, 1, 1)
    spec = spec_of((2 * mid,) * 3, (2, 2, 2))
    for dtype in (torch.float64, torch.float32):
        held(names[0], f"8 x {mid}^3", spec, one, asub.position_compute_tasks(spec, one), dtype,
             (0, 1, 2), 1)
        held(names[1], f"8 x {mid}^3 shells", spec, one, asub.position_shell_tasks(spec, one),
             dtype, (0,), 1)
    spec = spec_of(small, (2, 2, 2))
    label = f"uneven {'x'.join(map(str, small))} over (2, 2, 2)"
    held(names[0], label, spec, one, asub.position_compute_tasks(spec, one), torch.float32,
         (0, 1, 2), 1)
    held(names[0], label + ", position 3 off alignment", spec, one,
         asub.position_compute_tasks(spec, one), torch.float64, (0, 1, 2), 1, off_pos=(3,))
    held(names[1], label + " shells", spec, one, asub.position_shell_tasks(spec, one),
         torch.float64, (0,), 1, off_pos=(3,))
    spec = spec_of(many, (3, 2, 2))
    for dtype in (torch.float64, torch.float32):
        label = f"12 positions of {'x'.join(map(str, many))} over (3, 2, 2)"
        held(names[0], label, spec, one, asub.position_compute_tasks(spec, one), dtype,
             (0, 1, 2), 2)
        held(names[1], label + " shells", spec, one, asub.position_shell_tasks(spec, one), dtype,
             (0,), 2)
    spec = spec_of((40, 24, 20), (2, 2, 2))
    res = Dim3(1, 2, 2)
    held(names[0], "40x24x20 (2,2,2) on 2 positions", spec, res,
         asub.position_compute_tasks(spec, res), torch.float64, (0, 1, 2), 1)
    held(names[1], "40x24x20 (2,2,2) on 2 positions shells", spec, res,
         asub.position_shell_tasks(spec, res), torch.float64, (0,), 1)

    # -- the step over the mesh against the step over resident blocks --------------
    def counts():
        return (asub.substep_positions.launches, asub.substep_positions.shells,
                remote_dma.remote_axis.launches, halo_fill.self_fill.launches,
                fused_stencil.fused_exchange.launches, asub.substep_tasks.launches)

    def zero_counts():
        asub.substep_positions.launches = asub.substep_positions.shells = 0
        remote_dma.remote_axis.launches = halo_fill.self_fill.launches = 0
        fused_stencil.fused_exchange.launches = asub.substep_tasks.launches = 0

    def mesh_run(label, size, part, mesh_dim, mode, want, fused=False, dt=1e-5, ref=None):
        """``iters`` fp64 iterations from random fields over ``mesh_dim``
        positions (``mode``: overlap / serial / fused), launches (positions,
        of which shells, B6, B4, B7, one-stack) held to ``want`` an
        iteration; returns the gathered compute cells, torch.equal to
        ``ref`` when given."""
        spec = spec_of(size, part)
        stacked = {k: t for k, t in zip(FIELDS, (
            x[0] for x in stacks(spec, spec.dim, 1900, torch.float64)))}
        mesh = DeviceMesh(Dim3(*mesh_dim), [dev] * Dim3(*mesh_dim).flatten())
        ex = HaloExchange(spec, Method.REMOTE_DMA, mesh=mesh, fused=fused)
        curr = {k: split_positions(t, spec, mesh) for k, t in stacked.items()}
        nxt = {k: [torch.zeros_like(b) for b in v] for k, v in curr.items()}
        if fused:
            step = make_fused_astaroth_loop(ex, ainfo, iters=iters, dt=dt, dtype="float64")
        else:
            step = make_astaroth_step(ex, ainfo, dt=dt, iters=iters, dtype="float64",
                                      overlap=mode == "overlap")
        sync(dev)
        zero_counts()
        curr, nxt = step(curr, nxt)
        sync(dev)
        got = counts()
        check(got == tuple(w * iters * on_card for w in want),
              f"astaroth mesh {label}: launches (positions, shells, B6, B4, B7, one-stack) "
              f"{got}, expected {tuple(w * iters * on_card for w in want)}")
        cells = {k: join_positions(curr[k], spec) for k in FIELDS}
        if ref is None:
            # the same fields stepped over resident blocks of one stack
            rcurr = stacked
            rnxt = {k: torch.zeros_like(t) for k, t in rcurr.items()}
            rstep = make_astaroth_step(HaloExchange(spec), ainfo, dt=dt, iters=iters,
                                       dtype="float64", overlap=mode == "overlap")
            ref, _ = rstep(rcurr, rnxt)
        same = all(torch.equal(cells[k][mask(spec)], ref[k][mask(spec)]) for k in FIELDS)
        check(same, f"astaroth mesh {label}: not equal to the reference run")
        log(f"astaroth mesh {label} fp64 {iters} iterations: launches (positions, shells, B6, "
            f"B4, B7, one-stack) {got}, every compute cell equal to the "
            f"{'composed mesh step' if fused else 'resident run'}")
        return cells

    masks = {}

    def mask(spec):
        key = (spec.global_size, spec.dim)
        if key not in masks:
            masks[key] = torch.from_numpy(compute_mask(spec)).to(dev)
        return masks[key]

    cube = (2 * mid,) * 3
    over = mesh_run(f"(2,2,2) x {mid}^3 over 8 positions, overlap", cube, (2, 2, 2),
                    (2, 2, 2), "overlap", (4, 1, 3, 0, 0, 0))
    mesh_run(f"(2,2,2) x {mid}^3 over 8 positions, no overlap", cube, (2, 2, 2), (2, 2, 2),
             "serial", (3, 0, 3, 0, 0, 0))
    mesh_run(f"(2,2,2) x {mid}^3 fused loop", cube, (2, 2, 2), (2, 2, 2), "fused",
             (4, 1, 0, 0, 1, 0), fused=True, ref=over)
    del over
    mesh_run(f"(1,1,2) x {mid}^3 over 2 positions, overlap", (mid, mid, 2 * mid), (1, 1, 2),
             (1, 1, 2), "overlap", (4, 1, 1, 2, 0, 0))
    mesh_run("(2,2,2) x 40x24x20 on 4 positions, overlap", (40, 24, 20), (2, 2, 2), (2, 2, 1),
             "overlap", (4, 1, 3, 0, 0, 0))
    mesh_run(f"uneven {'x'.join(map(str, small))} over 8 positions", small, (2, 2, 2),
             (2, 2, 2), "overlap", (3, 0, 3, 0, 0, 0))
    masks.clear()
    log(f"astaroth mesh phase: steps done at {time.perf_counter() - t0:.1f} s")

    # -- the exchanges of the mesh step (B6, B7, B4) at this slice's shapes ----------
    def exchange_held(label, size, part, mesh_dim, fused, want, timed_ex):
        """One exchange of 8 random fp64 fields over ``mesh_dim`` positions
        against the resident exchange of the same stacks (every block's
        compute region and halos, edges and corners included: both copy
        bits), its launches (B6, B4, B7) held to
        ``want``; with ``timed_ex`` timed by CUDA events beside its bytes
        (each halo cell read and written once). Returns the ms."""
        spec = spec_of(size, part)
        stacked = {k: x[0] for k, x in zip(FIELDS, stacks(spec, spec.dim, 2200, torch.float64))}
        mesh = DeviceMesh(Dim3(*mesh_dim), [dev] * Dim3(*mesh_dim).flatten())
        ex = HaloExchange(spec, Method.REMOTE_DMA, mesh=mesh, fused=fused)
        state = {k: split_positions(t, spec, mesh) for k, t in stacked.items()}
        sync(dev)
        zero_counts()
        ex(state)
        sync(dev)
        got = counts()[2:5]
        check(got == tuple(w * on_card for w in want),
              f"astaroth exchange {label}: launches (B6, B4, B7) {got}, expected {want}")
        HaloExchange(spec)(stacked)
        # every block's compute region grown by its halos (edges and corners
        # included): the cells a stage reads
        off, b, r = spec.compute_offset(), spec.base, 3
        grown = (..., slice(off.z - r, off.z + b.z + r), slice(off.y - r, off.y + b.y + r),
                 slice(off.x - r, off.x + b.x + r))
        check(all(torch.equal(join_positions(state[k], spec)[grown], stacked[k][grown])
                  for k in FIELDS),
              f"astaroth exchange {label}: not equal to the resident exchange")
        ms = plain = lib = float("nan")
        if timed_ex:
            ms = time_ms(lambda: ex(state), 5, warmup=1)
            # the plain versions of every carrier the exchange launches (B6,
            # B7, B4) on the card's tensors, and Tensor.copy_ of the same
            # slabs or messages
            with plain_carriers(fill=True):
                plain = time_ms(lambda: ex(state), 2, warmup=1)
            lib = time_ms(lambda: copy_boxes(state, mesh, ex.plan) if fused else
                          copy_slabs(state, spec, mesh,
                                     [ph for ph in ex.plan.remote_phases if ph.active]),
                          3, warmup=1)
        nb = 2 * ex.bytes_logical([8] * 8)
        log(f"astaroth exchange {label} r3 8 fp64 fields: launches (B6, B4, B7) {got}, every "
            f"halo and compute cell equal to the resident exchange; {ms:.4f} ms ({nb / 2 / 1e6:.1f} MB of halos "
            f"read and written: bound {bound_ms(nb, 0)[0]:.4f} ms by bytes); plain versions "
            f"{plain:.4f} ms, Tensor.copy_ of the same slabs {lib:.4f} ms")
        del stacked, state
        return {"ms": ms, "plain_ms": plain, "copy_ms": lib}

    ex_ms = {
        "b6": exchange_held(f"(2,2,2) x {n}^3 over 8 positions (B6)", (2 * n,) * 3, (2, 2, 2),
                            (2, 2, 2), False, (3, 0, 0), timed),
        "b7": exchange_held(f"(2,2,2) x {n}^3 over 8 positions, fused (B7)", (2 * n,) * 3,
                            (2, 2, 2), (2, 2, 2), True, (0, 0, 1), timed),
        "b4": exchange_held(f"(1,1,2) x {n}^3 over 2 positions (B6 z, B4 x and y)",
                            (n, n, 2 * n), (1, 1, 2), (1, 1, 2), False, (1, 2, 0), timed),
    }
    log(f"astaroth mesh phase: exchanges done at {time.perf_counter() - t0:.1f} s")

    # -- the main path: the app over 8 positions -------------------------------------
    def app_run(label, dtype, overlap):
        zero_counts()
        ra = astaroth_app.run(iters=app_iters, nx=n, dtype=dtype, overlap=overlap,
                              devices=[dev] * 8, method=Method.REMOTE_DMA)
        sync(dev)
        it = ra["iters_run"] + 1  # the warm-up chunk advances the state
        got = counts()
        # B6: 3 phases an exchange, one an iteration and one after each
        # timed chunk (the app's exchange share)
        want = tuple(w * on_card for w in ((4 if overlap else 3) * it, it * overlap,
                                          3 * (it + ra["iters_run"]), 0, 0, 0))
        check(got == want, f"astaroth app {label}: launches (positions, shells, B6, B4, B7, "
                           f"one-stack) {got}, expected {want}")
        dd, h = ra["domain"], ra["handles"]
        p = dd.spec.padded()
        for k in FIELDS:
            ts = dd.get_curr(h[k])
            check(len(ts) == 8 and all(tuple(t.shape) == (1, 1, 1, p.z, p.y, p.x)
                                       and t.dtype == getattr(torch, dtype)
                                       and bool(torch.isfinite(t).all()) for t in ts),
                  f"astaroth app {label} {k}: not 8 finite blocks")
        check(dd.size == Dim3(2 * n, 2 * n, 2 * n) and ra["devices"] == 8
              and ra["processes"] == 1, f"astaroth app {label}: global {dd.size}, row "
                                         f"{ra['processes']} processes {ra['devices']} devices")
        log(astaroth_app.csv_row(ra))
        log(f"astaroth app {label}: {ra['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), "
            f"{ra['mcells_per_s']:.1f} Mcells/s, exchange {ra['exch_trimean_s'] * 1e3:.4f} ms, "
            f"launches {got}")
        return ra, got

    # one run each: the app's init of the 512^3 global fields takes most of
    # a run's 20 s
    per = {True: [], False: []}
    for overlap in (True, False):
        ra, got = app_run(f"8 positions x {n}^3 float64, {'overlap' if overlap else 'no overlap'}",
                          "float64", overlap)
        if names[0] not in launches:
            launches[names[0]], launches[names[1]] = got[0] - got[1], got[1]
        per[overlap].append(ra["iter_trimean_s"] * 1e3)
        del ra
    log(f"astaroth app 8 positions x {n}^3 float64: overlap {per[True][0]:.4f}, no overlap "
        f"{per[False][0]:.4f} ms/iter (gap {per[True][0] - per[False][0]:.4f} ms); resident "
        f"(2,2,2) x 256^3 overlap {RESIDENT_ITER_MS} ms/iter (PERF.md)")
    log(f"astaroth mesh phase: app runs done at {time.perf_counter() - t0:.1f} s")

    # -- the main path's shape: 8 positions of n^3 -----------------------------------
    spec = spec_of((2 * n,) * 3, (2, 2, 2))
    full, shells = asub.position_compute_tasks(spec, one), asub.position_shell_tasks(spec, one)
    label = f"8 x {n}^3"
    pl = held(names[0], label, spec, one, full, torch.float64, (0, 1), 1, time_plain=time_ms)
    pl_shells = held(names[1], label + " shells", spec, one, shells, torch.float64, (0,), 1,
                     time_plain=time_ms)[0]
    log(f"astaroth mesh phase: main shape held at {time.perf_counter() - t0:.1f} s")
    if not timed:
        return timings, launches, errs
    item = 8
    curr8, out8 = stacks(spec, one, 2000, torch.float64), stacks(spec, one, 2100, torch.float64)

    def run(tasks, s):
        return lambda: asub.substep_positions(curr8, out8, spec, tasks, consts, ids, s, 1e-8)

    st = [time_ms(run(full, s), 4, warmup=1, graph=True) for s in (0, 1)]
    cells = spec.global_size.flatten()
    nbytes = (asub.tasks_bytes(full, item, 0) + 2 * asub.tasks_bytes(full, item, 1)) / 3
    flops = (asub.FLOPS_PER_CELL[0] + 2 * asub.FLOPS_PER_CELL[1]) / 3 * cells
    t = dict(ms=(st[0] + 2 * st[1]) / 3, plain_ms=(pl[0] + 2 * pl[1]) / 3,
             bound=bound_ms(nbytes, flops, torch.float64), library_ms=None,
             extra={f"exchange_{label}_{k}": v
                    for name, label in (("b6", "b6"), ("b7", "b7"), ("b4", "mixed"))
                    for k, v in ex_ms[name].items()})
    sh_cells = sum((r.hi - r.lo).flatten() for _, _, r in shells)
    ts = dict(ms=time_ms(run(shells, 0), 6, warmup=1, graph=True), plain_ms=pl_shells,
              bound=bound_ms(asub.tasks_bytes(shells, item, 0),
                             asub.FLOPS_PER_CELL[0] * sh_cells, torch.float64), library_ms=None)
    timings[names[0]], timings[names[1]] = t, ts
    del curr8, out8
    # the resident table launch over the same cells, in the same call
    rcurr = [torch.rand(spec.stacked_shape_zyx(), generator=gen, device=dev,
                        dtype=torch.float64) * 0.1 for _ in range(8)]
    rout = [torch.rand_like(x) for x in rcurr]
    rfull = asub.compute_tasks(spec)
    rst = [time_ms(lambda s=s: asub.substep_tasks(rcurr, rout, spec, rfull, consts, ids, s, 1e-8),
                   4, warmup=1, graph=True) for s in (0, 1)]
    del rcurr, rout
    log(f"time astaroth_substep_positions 8 positions x {n}^3 float64: {t['ms']:.4f} ms per "
        f"launch on the main path's mix (stage 0 {st[0]:.4f}, stages 1-2 {st[1]:.4f}; plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by {t['bound'][1]}); the "
        f"resident table launch over the same cells {(rst[0] + 2 * rst[1]) / 3:.4f} ms in this "
        f"call ({RESIDENT_TABLE_MS} ms, PERF.md)")
    log(f"time astaroth_substep_positions_shells 48 shells of 8 positions x {n}^3 float64: "
        f"{ts['ms']:.4f} ms per launch ({sh_cells} cells; plain {ts['plain_ms']:.4f} ms, bound "
        f"{ts['bound'][0]:.4f} ms by {ts['bound'][1]})")
    log(f"astaroth mesh phase: {time.perf_counter() - t0:.1f} s")
    return timings, launches, errs


def plan_phase(dev, n: int = 512, mesh_n: int = 512, ast_n: int = 256,
               iters: int = 50, chunk: int = 25, swap_iters: int = 48, swap_chunk: int = 8,
               ast_iters: int = 3, cal_probes: int = 6, serve_edges=(32, 64), tmp=None):
    """Phase 18, the exchange planner on the card (``plan/``, rehearsable on
    the CPU at small sizes, where the plain versions count no launch):

    - ``apps.jacobi3d.run`` at ``n``^3 fp32 with ``autotune=True`` and a plan
      DB in a temporary directory, on one device: each candidate's static
      cost and each probe's trimean printed, no probe failed; launches
      counted from 0 around the run and held to the probes' exchanges (8 a
      probe: one warm-up loop of 4 and 4 timed), the chosen plan's loop (a
      warm-up chunk and the timed chunks) and the end-of-run attribution's
      40 exchanges; a second run hits the DB (zero probes, the same choice),
      its launches held to the plan's alone.
    - The same over ``["cuda:0"] * 8`` positions at ``mesh_n``^3 (strong):
      REMOTE_DMA plain and fused over the partitions of 8, B6 / B7 / B4
      launches of the probes printed and held.
    - The hot-swap: a guarded jacobi3d loop (``fault.run_guarded``) at
      ``mesh_n``^3 over 8 positions on the plain REMOTE_DMA plan (B1's
      positions sweep + B6) with a live sentinel, a status file and a
      ``ReplanController`` whose request is latched after the second chunk
      and whose re-tune returns the fused choice: the rest of the run goes
      through B8 (its launch counts held before and after the swap, the
      swap's one exchange by B7), ``replan.applied`` is recorded, the status
      file validates, and the compute region equals an unswapped run of the
      same steps (``torch.equal``). Both runs end with the exchange
      attribution.
    - Calibration: the plain carrier's probes over ``cal_probes``
      partitions of 8 besides (``autotune(variants=(None,))``, 40 exchanges
      a probe in 8 samples; B6 and B4 launches held), then the 8-position
      runs' metrics file through ``plan_tool calibrate --platform cuda``
      (its copy count: each exchange's kernel launches); the fitted row
      printed (n, r², each constant) and held to ``calibrate``'s checks
      (the fit and the DB's validation raise otherwise); the mesh config
      re-ranked with it, the static winner printed beside the measured
      one.
    - ``apps.astaroth.run`` at ``ast_n``^3 fp64 with ``autotune=True`` on one
      device: its probes (no failure), choice and substep launches.
    - Serving: the daemon (``apps/serve``'s scheduler from its flags) in
      process with ``--replan``, ``--plan-db``, ``--status-file`` and
      ``--live-sentinel`` over jacobi jobs of the two ``serve_edges``, one
      with a deadline under any p99: SLO pressure latches a swap at a slot
      boundary (``replan.applied``), the status file validates, and every
      result equals the batch ``CampaignDriver``'s on the same jobs.

    Returns ``(launches, report)``: the phase's launch count per kernel row
    of the kernels line, and the numbers PERF.md records."""
    from stencil_tpu_torch import DistributedDomain
    from stencil_tpu_torch.apps import astaroth as astaroth_app
    from stencil_tpu_torch.apps import jacobi3d, plan_tool
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.obs import telemetry
    from stencil_tpu_torch.obs.live import LiveSentinel
    from stencil_tpu_torch.obs.status import StatusWriter, read_status, validate_status
    from stencil_tpu_torch.ops import astaroth_substep as asub
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.ops import halo_fill
    from stencil_tpu_torch.ops import remote_dma as rdma
    from stencil_tpu_torch.ops import stencil_kernels as sk
    from stencil_tpu_torch.ops.jacobi import INIT_TEMP, make_jacobi_loop, sphere_sel_blocks
    from stencil_tpu_torch.fault import chunk_plan, run_guarded
    from stencil_tpu_torch.parallel import Method
    from stencil_tpu_torch.plan import db as plandb
    from stencil_tpu_torch.plan.autotune import autotune
    from stencil_tpu_torch.plan.cost import enumerate_candidates, feasible, rank
    from stencil_tpu_torch.plan.ir import PlanChoice, PlanConfig, build_plan
    from stencil_tpu_torch.plan.replan import ReplanController

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"  # the plain versions (a CPU rehearsal) count no launch
    tmp = tmp or tempfile.mkdtemp(prefix="plan_phase_")
    os.makedirs(tmp, exist_ok=True)
    db_path = os.path.join(tmp, "plans.json")
    counted = {"jacobi_sweep": sk.sweep, "jacobi_multistep": sk.multistep,
               "self_fill": halo_fill.self_fill, "fused_jacobi": fst.fused_jacobi,
               "remote_axis": rdma.remote_axis, "fused_exchange": fst.fused_exchange,
               "jacobi_sweep_positions": sk.sweep_positions,
               "fused_jacobi_mesh": fst.fused_jacobi_mesh,
               "astaroth_substep_resident": asub.substep_tasks}
    phase_launches = {name: 0 for name in counted}
    report = {}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def read():
        got = {name: fn.launches for name, fn in counted.items()}
        for name, v in got.items():
            phase_launches[name] += v
        return got

    def held(label, got, want):
        want = {k: v * on_card for k, v in want.items() if v * on_card}
        nonzero = {k: v for k, v in got.items() if v}
        check(nonzero == want, f"{label}: launches {nonzero}, expected {want}")
        log(f"{label}: launches {nonzero or '{}'} (held)")

    def exchange_launches(config, choice):
        """Kernel launches of one exchange of ``choice``'s plan."""
        spec, mesh_dim, resident = feasible(config, choice)
        if choice.method == Method.DIRECT26.value:
            return {}
        plan = build_plan(spec, mesh_dim, choice.method, resident=resident)
        if Dim3.of(mesh_dim).flatten() == 1:
            return {"self_fill": sum(1 for p in plan.axis_phases if p.active)}
        if choice.is_fused:
            return {"fused_exchange": 1}
        out = {"remote_axis": sum(1 for p in plan.remote_phases if p.active and p.ring > 1),
               "self_fill": sum(1 for p in plan.remote_phases if p.active and p.ring == 1)}
        return out

    def add(total, per, times):
        for k, v in per.items():
            total[k] = total.get(k, 0) + v * times

    def loop_launches(config, choice, chunks, temporal_k):
        """The jacobi loop of ``choice`` over ``chunks`` (step counts)."""
        out = {}
        steps = sum(chunks)
        mesh = config.ndev > 1
        if choice.method == Method.REMOTE_DMA.value:
            if choice.is_fused:
                add(out, {"fused_jacobi_mesh" if mesh else "fused_jacobi": 1}, steps)
            else:
                add(out, exchange_launches(config, choice), steps)
                add(out, {"jacobi_sweep_positions" if mesh else "jacobi_sweep": 1}, steps)
        elif choice.method == Method.DIRECT26.value:
            add(out, {"jacobi_sweep": 1}, steps)
        else:
            k = temporal_k
            for c in chunks:
                add(out, {"jacobi_multistep": c // k if k else 0, "jacobi_sweep": c % k if k else c}, 1)
        return out

    def probe_launches(config, probes):
        out = {}
        for p in probes:
            add(out, exchange_launches(config, PlanChoice.from_json(p["choice"])), 8)
        return out

    def show_tuning(label, res):
        log(f"{label}: {res.candidates} candidates, {res.probes_run} probes, chose "
            f"{res.choice.label()} ({res.source}, calibration {res.calibration_provenance})")
        for cost, ch in res.ranked[:6]:
            log(f"  static {ch.label():40s} {cost.total_s * 1e3:10.4f} ms/step "
                f"(exchange {cost.exchange_s * 1e3:.4f} ms, dmas {cost.dmas}, "
                f"wire {cost.wire_bytes} B)")
        for p in res.probes:
            check("trimean_s" in p, f"{label}: probe {p['label']} failed: {p.get('error')}")
            log(f"  probe  {p['label']:40s} {p['trimean_s'] * 1e3:10.4f} ms per exchange, "
                f"{p['gb_per_s']:.2f} GB/s logical")
        report[label] = {"choice": res.choice.label(), "source": res.source,
                         "probes": {p["label"]: p["trimean_s"] for p in res.probes},
                         "static": {ch.label(): c.total_s for c, ch in res.ranked[:6]}}

    # -- autotune on one device, then the DB hit ------------------------------------
    chunks = [chunk] * (1 + iters // chunk)  # the warm-up chunk advances the state
    one_metrics = os.path.join(tmp, "one.jsonl")
    for attempt in ("tune", "hit"):
        telemetry.configure(metrics_out=one_metrics, app="chip_smoke")
        sync(dev)
        reset()
        r = jacobi3d.run(n, n, n, iters=iters, chunk=chunk, weak=False, device=dev,
                         autotune=True, plan_db=db_path)
        sync(dev)
        got = read()
        res = r["domain"].autotune_result
        config = res.config
        want = loop_launches(config, res.choice, chunks, r["temporal_k"])
        add(want, exchange_launches(config, res.choice), 40)  # the attribution epilogue
        if attempt == "tune":
            show_tuning(f"jacobi3d {n}^3 autotune on one device", res)
            check(not res.cache_hit and res.probes_run == len(res.probes) > 0,
                  f"one-device autotune: {res.probes_run} probes, cache hit {res.cache_hit}")
            add(want, probe_launches(config, res.probes), 1)
            first = res.choice
        else:
            check(res.cache_hit and res.probes_run == 0 and res.choice == first,
                  f"one-device DB replay: cache hit {res.cache_hit}, {res.probes_run} probes, "
                  f"{res.choice.label()} (tuned {first.label()})")
            log(f"jacobi3d {n}^3 autotune again: DB hit, zero probes, {res.choice.label()}")
        held(f"jacobi3d {n}^3 one device, {attempt} ({res.choice.label()}, "
             f"k={r['temporal_k']})", got, want)
        report[f"one device {attempt} iter_trimean_s"] = r["iter_trimean_s"]
        del r, res
    telemetry.configure(None)

    # -- autotune over 8 positions of the card ----------------------------------------
    mesh_metrics = os.path.join(tmp, "mesh.jsonl")
    telemetry.configure(metrics_out=mesh_metrics, app="chip_smoke")
    devices = [dev] * 8
    for attempt in ("tune", "hit"):
        sync(dev)
        reset()
        r = jacobi3d.run(mesh_n, mesh_n, mesh_n, iters=iters, chunk=chunk, weak=False,
                         devices=devices, method=Method.REMOTE_DMA, autotune=True,
                         plan_db=db_path)
        sync(dev)
        got = read()
        res = r["domain"].autotune_result
        config = res.config
        want = loop_launches(config, res.choice, chunks, 0)
        add(want, exchange_launches(config, res.choice), 40)
        if attempt == "tune":
            show_tuning(f"jacobi3d {mesh_n}^3 autotune over 8 positions", res)
            check(not res.cache_hit and res.probes_run == len(res.probes) > 0,
                  f"mesh autotune: {res.probes_run} probes, cache hit {res.cache_hit}")
            probes = probe_launches(config, res.probes)
            log(f"  the probes' launches: B6 {probes.get('remote_axis', 0) * on_card}, "
                f"B7 {probes.get('fused_exchange', 0) * on_card}, "
                f"B4 {probes.get('self_fill', 0) * on_card}")
            add(want, probes, 1)
            mesh_first = res.choice
            mesh_config = config
        else:
            check(res.cache_hit and res.probes_run == 0 and res.choice == mesh_first,
                  f"mesh DB replay: cache hit {res.cache_hit}, {res.probes_run} probes, "
                  f"{res.choice.label()}")
            log(f"jacobi3d {mesh_n}^3 over 8 positions again: DB hit, zero probes")
        held(f"jacobi3d {mesh_n}^3 over 8 positions, {attempt} ({res.choice.label()})", got,
             want)
        report[f"mesh {attempt} iter_trimean_s"] = r["iter_trimean_s"]
        del r, res

    # -- the hot-swap: plain REMOTE_DMA (B1 + B6) -> fused (B8) between chunks --------
    plain = PlanChoice((2, 2, 2), Method.REMOTE_DMA.value)
    fused = PlanChoice((2, 2, 2), Method.REMOTE_DMA.value, kernel_variant="fused")
    status_path = os.path.join(tmp, "status.json")

    def guarded(swap: bool):
        dd = DistributedDomain(mesh_n, mesh_n, mesh_n, device=dev, plan=plain)
        dd.set_devices(devices)
        dd.set_radius(1)
        h = dd.add_data("temperature", "float32")
        dd.realize()
        for b in dd.get_curr(h):
            b.fill_(INIT_TEMP)
        sel = sphere_sel_blocks(dd.spec, dd.mesh)
        nxt = dd.get_next(h)
        loops = {}
        rec = telemetry.get()

        def step_fn(st, k):
            nonlocal nxt
            if k not in loops:
                loops[k] = make_jacobi_loop(dd.halo_exchange, k)
            c, nxt = loops[k](st["temperature"], nxt, sel)
            sync(dev)
            return {"temperature": c}

        def apply_fn(choice, st):
            nonlocal sel, nxt
            dd.set_curr(h, st["temperature"])
            dd.replan(choice)
            loops.clear()
            sel = sphere_sel_blocks(dd.spec, dd.mesh)
            nxt = dd.get_next(h)
            return {"temperature": dd.get_curr(h)}

        sentinel = LiveSentinel(rec=rec) if swap else None
        status = StatusWriter(status_path, app="chip_smoke", run=rec.run_id) if swap else None
        controller = None
        if swap:
            controller = ReplanController(
                lambda: fused, apply_fn, sentinel=sentinel,
                current_choice=PlanChoice.from_json(dd.plan_meta()["choice"]),
                config=PlanConfig.make(dd.size, dd.radius, ["float32"], 8, dev.type))
        chunks_seen = []
        before = {}

        def on_chunk(st, k, per, done):
            chunks_seen.append(k)
            if swap and len(chunks_seen) == 2:
                sync(dev)
                before.update(read())
                reset()
                # a request as the sentinel's hook would latch it, so that the
                # check does not wait on a real slowdown
                controller.request({"reason": "latched after chunk 2", "step": done})

        sync(dev)
        reset()
        state, done = run_guarded({"temperature": dd.get_curr(h)}, start=0, iters=swap_iters,
                                  plan_fn=lambda s: chunk_plan(s, swap_iters, swap_chunk),
                                  step_fn=step_fn, on_chunk=on_chunk, sentinel=sentinel,
                                  status=status, replan=controller, app="chip_smoke")
        sync(dev)
        after = read()
        dd.set_curr(h, state["temperature"])
        dd.set_next(h, nxt)
        jacobi3d.attribute_exchange(dd, h, swap_chunk, rec, devices)
        return dd, h, controller, before, after, status

    dd_ref, h_ref, _c, _b, ref_counts, _s = guarded(False)
    steps_before = 2 * swap_chunk
    held(f"guarded {mesh_n}^3 over 8 positions, unswapped ({swap_iters} plain steps)",
         ref_counts, {"remote_axis": 3 * swap_iters, "jacobi_sweep_positions": swap_iters})
    ref = dd_ref.get_curr_global(h_ref)
    del dd_ref
    dd_sw, h_sw, controller, before, after, status = guarded(True)
    held(f"hot-swap, before the swap ({steps_before} plain steps)", before,
         {"remote_axis": 3 * steps_before, "jacobi_sweep_positions": steps_before})
    # the swap's one exchange (B7 under the fused plan) and then B8 a step
    held(f"hot-swap, after the swap ({swap_iters - steps_before} fused steps)", after,
         {"fused_exchange": 1, "fused_jacobi_mesh": swap_iters - steps_before})
    check(controller.swaps == 1 and dd_sw.plan_choice == fused,
          f"hot-swap: {controller.swaps} swaps, plan {dd_sw.plan_choice}")
    recs = [json.loads(ln) for ln in open(mesh_metrics) if ln.strip()]
    applied = [x for x in recs if x.get("name") == "replan.applied"]
    check(len(applied) == 1 and applied[0]["new"] == fused.label(),
          f"hot-swap: replan.applied records {applied}")
    doc = read_status(status_path)
    errs_s = validate_status(doc)
    check(doc is not None and not errs_s and doc["step"] == swap_iters,
          f"hot-swap: status file {doc} invalid: {errs_s}")
    got = dd_sw.get_curr_global(h_sw)
    same = torch.equal(torch.from_numpy(got), torch.from_numpy(ref))
    check(same, "hot-swap: the swapped run's compute region differs from the unswapped run")
    log(f"hot-swap {plain.label()} -> {fused.label()} after chunk 2 of {swap_iters // swap_chunk}: "
        f"replan.applied recorded, status file valid (step {doc['step']}), compute region "
        "torch.equal to the unswapped run")
    del dd_sw, got, ref

    # -- the card's calibration row, from the 8-position runs -------------------------
    # plus the plain carrier's probes over more partitions of 8 (B6 on the ring
    # axes, B4 on the others; the tuned runs above probe the statically best
    # few, which may all be fused)
    sync(dev)
    reset()
    res = autotune(Dim3(mesh_n, mesh_n, mesh_n), Radius.constant(1), ["float32"],
                   devices=devices, variants=(None,), top_n=cal_probes, probe_iters=40,
                   force=True)
    sync(dev)
    got = read()
    show_tuning(f"{mesh_n}^3 over 8 positions, the plain carrier's probes", res)
    want = {}
    for p in res.probes:  # 40 timed exchanges and 5 warm-up ones a probe
        add(want, exchange_launches(res.config, PlanChoice.from_json(p["choice"])), 45)
    held(f"the plain carrier's {len(res.probes)} probes (B6, B4)", got, want)
    telemetry.configure(None)
    out = subprocess.run([sys.executable, "-m", "stencil_tpu_torch.apps.plan_tool", "calibrate",
                          "--db", db_path, "--platform", dev.type, "--from-metrics",
                          mesh_metrics], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in out.stdout.splitlines():
        log(f"  calibrate: {line}")
    check(out.returncode == 0, f"plan_tool calibrate failed: {out.stderr[-2000:]}")
    row = plandb.lookup_calibration(plandb.load_db(db_path), dev.type)
    check(row is not None and row["n"] >= 2 and row["r2"] == row["r2"],
          f"calibration row {row}")
    cal = row["calibration"]
    log(f"fitted {dev.type} row: n={row['n']} r2={row['r2']:.4f} bandwidth fitted "
        f"{row['bandwidth_fit']}: {json.dumps(cal, sort_keys=True)}")
    reranked = rank(mesh_config, enumerate_candidates(mesh_config, methods=("remote-dma",)), cal)
    log(f"re-ranked with the fitted row: static winner {reranked[0][1].label()} "
        f"({reranked[0][0].total_s * 1e3:.4f} ms/step); measured winner {mesh_first.label()}")
    report["calibration"] = {k: row[k] for k in ("n", "r2", "bandwidth_fit", "provenance")}
    report["calibration"]["calibration"] = cal
    report["reranked_winner"] = reranked[0][1].label()

    # -- astaroth --autotune on one device ------------------------------------------
    sync(dev)
    reset()
    r = astaroth_app.run(iters=ast_iters, nx=ast_n, dtype="float64", device=dev, autotune=True,
                         plan_db=db_path)
    sync(dev)
    got = read()
    res = r["domain"].autotune_result
    show_tuning(f"astaroth {ast_n}^3 fp64 autotune on one device", res)
    check(got["astaroth_substep_resident"] == 3 * (ast_iters + 1) * on_card,
          f"astaroth autotune: {got['astaroth_substep_resident']} substep launches, expected "
          f"{3 * (ast_iters + 1) * on_card}")
    log(f"astaroth {ast_n}^3 fp64 on {r['plan']}: {r['iter_trimean_s'] * 1e3:.4f} ms/iter, "
        f"launches {dict((k, v) for k, v in got.items() if v)}")
    report["astaroth iter_trimean_s"] = r["iter_trimean_s"]
    del r, res

    # -- serving with the live layer and the between-slot swap ------------------------
    from stencil_tpu_torch.apps import serve as serve_app
    from stencil_tpu_torch.apps._bench_common import (canonicalize_live_config, finish_live,
                                                      make_live)
    from stencil_tpu_torch.campaign import CampaignDriver
    from stencil_tpu_torch.serve import job_from_doc

    sdir, smetrics, sstatus = (os.path.join(tmp, n) for n in ("srv", "serve.jsonl",
                                                              "serve-status.json"))
    inc = os.path.join(sdir, "jobs", "incoming")
    os.makedirs(inc)
    for i, (jid, edge, deadline) in enumerate((("s0", serve_edges[0], 1e-3),
                                                ("s1", serve_edges[0], None),
                                                ("s2", serve_edges[1], None))):
        job = {"job": jid, "size": edge, "steps": 6, "workload": "jacobi",
               "dtype": "float32", "seed": 30 + i}
        if deadline is not None:
            job["deadline_ms"] = deadline  # under any p99: SLO pressure
        with open(os.path.join(inc, f".tmp-{jid}.json"), "w") as f:
            json.dump(job, f)
        os.replace(os.path.join(inc, f".tmp-{jid}.json"), os.path.join(inc, f"{jid}.json"))
    args = serve_app.parser().parse_args([
        "--serve-dir", sdir, "--slot", "2", "--device", str(dev), "--chunk", "2",
        "--max-idle-s", "0.5", "--poll-s", "0.02", "--replan", "--plan-db", db_path,
        "--status-file", sstatus, "--live-sentinel", "--metrics-out", smetrics])
    canonicalize_live_config(args)
    rec = telemetry.configure(metrics_out=smetrics, app="serve")
    sentinel, status = make_live(args, rec, "serve")
    sched = serve_app.build_scheduler(args, {}, sentinel=sentinel, status=status)
    out = sched.serve()
    finish_live(rec, sentinel, status, outcome=out["outcome"])
    telemetry.configure(None)
    recs = [json.loads(ln) for ln in open(smetrics) if ln.strip()]
    applied = [x for x in recs if x["name"] == "replan.applied"]
    pressure = [x for x in recs if x["name"] == "replan.requested"
                and x.get("reason") == "slo-pressure"]
    doc = read_status(sstatus)
    check(out["retired"] == 3 and pressure and applied and not validate_status(doc)
          and doc["outcome"] == out["outcome"] and doc["queue"]["retired"] == 3,
          f"serve with the live layer: {out['retired']} retired, {len(pressure)} pressure "
          f"requests, {len(applied)} swaps, status {doc}")
    specs = {}
    for name in sorted(os.listdir(os.path.join(sdir, "jobs", "claimed"))):
        with open(os.path.join(sdir, "jobs", "claimed", name)) as f:
            specs[name[:-5]] = json.load(f)
    jobs = [job_from_doc(specs[j], i) for i, j in enumerate(sorted(specs))]
    batch = CampaignDriver(jobs, 2, os.path.join(tmp, "batch"), device=dev, chunk=2).run()
    for jid in sorted(specs):
        a, c = out["results"][jid].finals, batch["results"][jid].finals
        check(sorted(a) == sorted(c) and all(a[k].tobytes() == c[k].tobytes() for k in a),
              f"serve with the live layer: job {jid} != the batch CampaignDriver's")
    log(f"serve with --replan --plan-db --status-file --live-sentinel: 3 jobs retired over "
        f"{out['slots']} slots, SLO pressure swapped {applied[0]['old']} -> {applied[0]['new']} "
        f"between slots, status file valid, every result byte-equal to the batch driver's")
    log(f"phase 18 (plan) {time.perf_counter() - t0:.1f} s")
    return phase_launches, report


# -- phase 19: the measurement tools ------------------------------------------------

# each launch counter beside the __global__ kernel its wrapper launches (the
# trace names a kernel by its demangled signature: match by this prefix)
GLOBAL_OF = {"multistep": "jacobi_multistep_kernel", "sweep": "jacobi_sweep_kernel",
             "sweep_positions": "jacobi_sweep_kernel", "remote_axis": "move_rows_kernel",
             "fused_jacobi_mesh": "fused_step_kernel",
             "persistent_jacobi_mesh": "persistent_jacobi_kernel",
             "health_reduce": "health_kernel"}


def kernel_base(name: str) -> str:
    """A kernel's ``__global__`` name from the trace's demangled signature,
    its namespaces dropped (``void (anonymous
    namespace)::jacobi_multistep_kernel<3, float>(Params<float>)`` and
    ``void row_moves::move_rows_kernel<...>(...)`` -> the bare name)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        i = name.find(stop)
        if i > 0:
            name = name[:i]
    return name.strip().rsplit("::", 1)[-1]


def trace_x_events(logdir: str):
    """Every complete event of the Chrome-trace dumps under ``logdir``."""
    evs = []
    for path in glob.glob(os.path.join(logdir, "**", "*.trace.json"), recursive=True):
        with open(path) as f:
            evs += [e for e in json.load(f).get("traceEvents", [])
                    if isinstance(e, dict) and e.get("ph") == "X"
                    and isinstance(e.get("dur"), (int, float))]
    return evs


def device_span(evs, name: str, work_cats):
    """``(lo, hi, route)`` in µs of range ``name`` on the device timeline:
    its ``gpu_user_annotation`` events, else the device work whose launch
    (the runtime event with its correlation id) lies in the host range."""
    ann = [e for e in evs if e.get("cat") == "gpu_user_annotation" and e.get("name") == name]
    if ann:
        return (min(e["ts"] for e in ann), max(e["ts"] + e["dur"] for e in ann),
                "gpu_user_annotation")
    host = [e for e in evs if e.get("cat") == "user_annotation" and e.get("name") == name]
    launch = {(e.get("args") or {}).get("correlation"): e["ts"] for e in evs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    work = [e for e in evs if e.get("cat") in work_cats
            and any(h["ts"] <= launch.get((e.get("args") or {}).get("correlation"), -1)
                    <= h["ts"] + h["dur"] for h in host)]
    if not work:
        return None
    return (min(e["ts"] for e in work), max(e["ts"] + e["dur"] for e in work), "correlation")


def busy_share(evs, lo: float, hi: float, work_cats) -> float:
    """The union of the device work's intervals over ``[lo, hi]``, as a
    share of it."""
    iv = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in evs
                if e.get("cat") in work_cats and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for s, e in iv:
        s = max(s, end)
        if e > s:
            busy += e - s
            end = e
    return busy / (hi - lo) if hi > lo else 0.0


def tools_phase(dev, n: int = 512, chunk: int = 25, variant_n: int = 256, ex_n: int = 256,
                ex_iters: int = 20, pack_n: int = 512, pack_iters: int = 20,
                overlap_n: int = 512, overlap_iters: int = 10, rounds: int = 3):
    """Phase 19, the measurement tools on the card (rehearsable on the CPU at
    small sizes, where ``capture`` yields False and the plain versions count
    no launch):

    a. ``obs.xprof.capture`` around ``apps.jacobi3d.run`` at ``n``^3 fp32 on
       one block (a warm-up chunk and one timed ``chunk``-step chunk), then
       around the plain remote-dma loop over 8 positions: the gate yields
       True, the dump is found and parsed, ``range_seconds`` gives device
       seconds > 0 for ``jacobi.chunk``, each kernel's event count equals its
       wrapper's launch counter around the same run, the chunk's own
       kernels are one chunk's, the profiler's mean multistep duration is
       within 15% of the CUDA-event time of the same launch shape (timed
       right after the capture), the five kernels with the most device seconds
       and each chunk's device busy share (the union of the device work over
       the chunk's device span) printed; then a capture of the cooperative
       launches (B8's and B9's mesh forms), the health kernel and a CUDA
       graph's replay, each kernel's events beside its launches (what does
       not show is printed, not failed).
    b. The record tools on a metrics file of the one-block run:
       ``trace_export.write_trace`` and ``validate_trace`` == [],
       ``report --validate`` 0, ``report``'s chunk spans (``jacobi.iter``),
       ``perf_tool ingest`` under two labels, ``trend``, ``gate`` (0 or 1).
    c. ``apps.bench_exchange``: the radius sweep at ``ex_n``^3 x4 on one
       block (5 rows, B4's launches held to the plans'), the ablation over
       (2,2,2) residents (three methods bit for bit, auto-spmd skipped,
       census 6 / 26 / 0), REMOTE_DMA plain and fused over 8 positions at
       config 2 (launches held) and the bf16 wire A/B there (its gate).
    d. ``apps.bench_pack`` at ``pack_n``^3 r3: 26 rows, each direction's
       bytes its halo rect's.
    e. ``apps.measure_overlap`` at ``overlap_n``^3 over 8 positions (strong),
       r1, with ``--trace``: the four variants and ``hidden_frac``, and
       ``range_seconds`` on the trace finds the sweep kernel.

    Returns ``(report, profiler_ms)``: the numbers PERF.md records, and the
    profiler's mean kernel ms of the B2 and B1 rows on the main path."""
    import contextlib
    import io

    from stencil_tpu_torch.apps import bench_exchange as be
    from stencil_tpu_torch.apps import bench_pack as bp
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.apps import measure_overlap as mo
    from stencil_tpu_torch.apps import perf_tool, report as report_app
    from stencil_tpu_torch.apps._bench_common import time_exchange
    from stencil_tpu_torch.domain import GridSpec
    from stencil_tpu_torch.geometry import DIRECTIONS_26, Dim3, Radius, halo_rect
    from stencil_tpu_torch.obs import telemetry, trace_export, xprof
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.ops import halo_fill
    from stencil_tpu_torch.ops import health_reduce as hr
    from stencil_tpu_torch.ops import persistent_stencil as pst
    from stencil_tpu_torch.ops import remote_dma as rdma
    from stencil_tpu_torch.ops import stencil_kernels as sk
    from stencil_tpu_torch.ops.jacobi import sphere_sel_blocks
    from stencil_tpu_torch.parallel import Method
    from stencil_tpu_torch.plan.ir import build_plan
    from stencil_tpu_torch.utils.timer import cuda_time_ms

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    pos8 = [dev] * 8
    wrappers = {"multistep": sk.multistep, "sweep": sk.sweep,
                "sweep_positions": sk.sweep_positions, "remote_axis": rdma.remote_axis,
                "fused_jacobi_mesh": fst.fused_jacobi_mesh,
                "persistent_jacobi_mesh": pst.persistent_jacobi_mesh,
                "health_reduce": hr.health_reduce}
    work = xprof.DEVICE_WORK
    out, prof_ms = {}, {}
    tmp_ctx = tempfile.TemporaryDirectory(prefix="tools_phase_")
    tmp = tmp_ctx.name

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def kernel_events(logdir):
        """{__global__ name: [durations µs]} of a capture's kernels."""
        got = {}
        for e in xprof.device_events(logdir):
            if e["cat"] == "kernel":
                got.setdefault(kernel_base(e["name"]), []).append(e["dur"])
        return got

    def held(label, logdir, names):
        """Each wrapper's launches beside its kernel's events, held equal;
        returns the capture's kernel events."""
        kev = kernel_events(logdir)
        log(f"tools {label}: kernels in the trace: "
            + ", ".join(f"{name} x{len(d)}" for name, d in sorted(kev.items())))
        for w in names:
            g = GLOBAL_OF[w]
            evn = len(kev.get(g, ()))
            log(f"tools {label}: {w} launches {wrappers[w].launches}, {g} events {evn}")
            check(evn == wrappers[w].launches,
                  f"tools {label}: {evn} {g} events in the trace, {wrappers[w].launches} expected")
        return kev

    # -- a. the capture of the main path ----------------------------------------------
    k = sk.plan_multistep_depth(min(sk.TEMPORAL_K_CAP, (n - 1) // 2, chunk))
    per_chunk = {"multistep": chunk // k, "sweep": chunk % k}
    captures = [("one block", os.path.join(tmp, "one"), dict(), ("multistep", "sweep"),
                 per_chunk),
                ("8 positions", os.path.join(tmp, "mesh"),
                 dict(devices=pos8, method=Method.REMOTE_DMA), ("remote_axis",
                                                                 "sweep_positions"),
                 {"remote_axis": 3 * chunk, "sweep_positions": chunk})]
    for label, logdir, kw, names, one_chunk in captures:
        zero()
        sync(dev)
        with xprof.capture(logdir) as tracing:
            r = jacobi3d.run(n, n, n, iters=chunk, weak=False, chunk=chunk, warmup=1,
                             device=None if kw else dev, **kw)
        sync(dev)
        check(tracing == on_card, f"tools {label}: the capture's gate yielded {tracing} on "
              f"{dev.type}")
        got = {w: wrappers[w].launches for w in names}
        want = {w: 2 * v * on_card for w, v in one_chunk.items()}
        check(got == want, f"tools {label}: launches {got} around a warm-up and one chunk, "
              f"expected {want}")
        log(f"tools {label} {n}^3: {r['iter_trimean_s'] * 1e3:.4f} ms/iter, launches {got}, "
            f"capture {'on' if tracing else 'off (no CUDA profiler)'}")
        del r
        if not tracing:
            check(not os.path.exists(logdir), f"tools {label}: a capture that is off wrote")
            continue
        # one dump, where range_seconds looks for it
        files = glob.glob(os.path.join(logdir, "plugins", "profile", "*", "*.trace.json"))
        check(len(files) == 1, f"tools {label}: {len(files)} dumps under {logdir}")
        secs = xprof.range_seconds(logdir, ["jacobi.chunk"])
        check(secs.get("jacobi.chunk", 0) > 0, f"tools {label}: no device seconds for "
              f"jacobi.chunk ({secs})")
        kev = held(label, logdir, names)
        evs = trace_x_events(logdir)
        span = device_span(evs, "jacobi.chunk", work)
        check(span is not None, f"tools {label}: no device span for jacobi.chunk")
        lo, hi, route = span
        inside = {}
        for e in evs:
            if e.get("cat") == "kernel" and lo <= e["ts"] and e["ts"] + e["dur"] <= hi:
                inside[kernel_base(e["name"])] = inside.get(kernel_base(e["name"]), 0) + 1
        check(all(inside.get(GLOBAL_OF[w], 0) == v for w, v in one_chunk.items()),
              f"tools {label}: {inside} kernels inside the chunk's span, {one_chunk} expected")
        share = busy_share(evs, lo, hi, work)
        allk = {}
        for e in xprof.device_events(logdir):
            allk[kernel_base(e["name"])] = allk.get(kernel_base(e["name"]), 0.0) + e["dur"]
        five = sorted(allk.items(), key=lambda kv: -kv[1])[:5]
        log(f"tools {label}: jacobi.chunk {secs['jacobi.chunk'] * 1e3:.4f} ms on the device "
            f"(range_seconds), span {(hi - lo) / 1e3:.4f} ms by {route}, device busy "
            f"{share:.4f} of it; kernels inside {inside}")
        log(f"tools {label}: top five kernels by device ms: "
            + ", ".join(f"{name} {us / 1e3:.4f}" for name, us in five))
        out[label] = {"chunk_device_ms": secs["jacobi.chunk"] * 1e3,
                      "span_ms": (hi - lo) / 1e3, "span_route": route, "busy_share": share,
                      "top5_ms": {name: us / 1e3 for name, us in five}}
        for w in names:
            d = kev.get(GLOBAL_OF[w], [])
            mean = sum(d) / len(d) / 1e3
            out[label][f"{GLOBAL_OF[w]}_mean_ms"] = mean
            if label == "one block":
                prof_ms["jacobi_multistep" if w == "multistep" else "jacobi_sweep"] = mean
    if on_card:
        # the same launch shapes timed by CUDA events (a CUDA graph of 20
        # launches replayed), outside any capture
        spec = GridSpec(Dim3(n, n, n), Dim3(1, 1, 1), Radius.constant(1))
        c = torch.rand(spec.stacked_shape_zyx(), device=dev)
        x = torch.zeros_like(c)
        sel = sphere_sel_blocks(spec, dev)
        ev_ms = {"jacobi_multistep": cuda_time_ms(lambda: sk.multistep(c, x, spec, k), 20,
                                                  graph=True),
                 "jacobi_sweep": cuda_time_ms(lambda: sk.sweep(c, x, sel, spec, (True,) * 3,
                                                               sk.sel_z_range(spec)), 20,
                                              graph=True)}
        del c, x, sel
        for w, row in (("multistep", "jacobi_multistep"), ("sweep", "jacobi_sweep")):
            log(f"tools: {GLOBAL_OF[w]} at {n}^3 on the main path: profiler mean "
                f"{prof_ms[row]:.4f} ms, CUDA events {ev_ms[row]:.4f} ms")
        check(abs(prof_ms["jacobi_multistep"] - ev_ms["jacobi_multistep"])
              <= 0.15 * ev_ms["jacobi_multistep"],
              f"tools: the profiler's multistep mean {prof_ms['jacobi_multistep']:.4f} ms is "
              f"not within 15% of its CUDA-event time {ev_ms['jacobi_multistep']:.4f} ms")
        out["profiler_ms"] = dict(prof_ms)
        out["cuda_event_ms"] = ev_ms

        # the cooperative launches, the health kernel and a CUDA graph's replay
        logdir = os.path.join(tmp, "variants")
        zero()
        shows = {}
        with xprof.capture(logdir):
            jacobi3d.run(variant_n, variant_n, variant_n, iters=2, weak=False, chunk=2,
                         warmup=0, devices=pos8, method=Method.REMOTE_DMA,
                         kernel_variant="fused")
            jacobi3d.run(variant_n, variant_n, variant_n, iters=4, weak=False, chunk=4,
                         warmup=0, devices=pos8, method=Method.REMOTE_DMA,
                         kernel_variant="persistent", deep_halo=4)
            jacobi3d.run(variant_n, variant_n, variant_n, iters=4, weak=False, chunk=2,
                         warmup=0, device=dev, health_every=2)
            graph_launches = sk.multistep.launches
            spec = GridSpec(Dim3(variant_n, variant_n, variant_n), Dim3(1, 1, 1),
                            Radius.constant(1))
            c = torch.zeros(spec.stacked_shape_zyx(), device=dev)
            x = torch.zeros_like(c)
            try:
                cuda_time_ms(lambda: sk.multistep(c, x, spec, k), 3, warmup=1, graph=True)
                graph_note = "graph replayed"
            except Exception as e:  # noqa: BLE001 - what does not work is recorded
                graph_note = f"graph capture under the profiler failed: {e}"
            graph_launches = sk.multistep.launches - graph_launches
            sync(dev)
        kev = kernel_events(logdir)
        for w in ("fused_jacobi_mesh", "persistent_jacobi_mesh", "health_reduce"):
            g = GLOBAL_OF[w]
            shows[w] = (wrappers[w].launches, len(kev.get(g, ())))
            log(f"tools variants: {w} ({g}) launches {shows[w][0]}, events {shows[w][1]}"
                + ("" if shows[w][0] == shows[w][1] else "  <- NOT all in the trace"))
        # the graph: 1 warm-up and 3 captured calls counted, 1 + 3 replayed kernels run
        ms_ev = len(kev.get("jacobi_multistep_kernel", ()))
        log(f"tools variants: CUDA graph of the multistep: {graph_note}; wrapper counted "
            f"{graph_launches} (warm-up + captured calls), the trace holds {ms_ev} "
            f"jacobi_multistep_kernel events (of which the health run's own)")
        out["variants"] = {w: {"launches": a, "events": b} for w, (a, b) in shows.items()}
        out["variants"]["graph"] = {"note": graph_note, "counted": graph_launches,
                                    "multistep_events": ms_ev}
        del c, x
    log(f"tools phase: captures done at {time.perf_counter() - t0:.1f} s")

    # -- b. the record tools on a metrics file of the one-block run ---------------------
    metrics = os.path.join(tmp, "m.jsonl")
    telemetry.configure(metrics_out=metrics, app="jacobi3d", config={"x": n, "device": "card"})
    try:
        jacobi3d.run(n, n, n, iters=chunk, weak=False, chunk=chunk, warmup=1,
                     device=dev)
    finally:
        telemetry.configure()
    records, errors = report_app.load([metrics])
    check(not errors and records, f"tools: metrics file errors {errors[:3]}")
    trace_path = os.path.join(tmp, "trace.json")
    n_ev = trace_export.write_trace(trace_path, records)
    with open(trace_path) as f:
        check(trace_export.validate_trace(json.load(f)) == [], "tools: invalid trace")

    def cli(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue()

    rc, text = cli(report_app.main, [metrics, "--validate"])
    check(rc == 0, f"tools: report --validate rc {rc}: {text}")
    rc, text = cli(report_app.main, [metrics])
    spans = [ln for ln in text.splitlines() if ln.startswith("jacobi.iter,")]
    check(rc == 0 and spans, f"tools: report printed no chunk spans (rc {rc})")
    log(f"tools: {len(records)} records, trace of {n_ev} events valid, report --validate "
        f"rc 0; the chunk spans: {spans[0]}")
    led = os.path.join(tmp, "L.jsonl")
    for label in ("tools-a", "tools-b"):
        rc, text = cli(perf_tool.main, ["ingest", "--ledger", led, "--label", label,
                                        "--platform", dev.type, "--spans", metrics])
        check(rc == 0, f"tools: perf_tool ingest rc {rc}")
    rc, text = cli(perf_tool.main, ["trend", "--ledger", led])
    check(rc == 0, f"tools: perf_tool trend rc {rc}")
    rc, text = cli(perf_tool.main, ["gate", "--ledger", led])
    check(rc in (0, 1), f"tools: perf_tool gate rc {rc} (a usage error)")
    verdicts = [ln for ln in text.splitlines() if ln.startswith("GATE")]
    log(f"tools: perf_tool gate rc {rc}, {len(verdicts)} verdicts, e.g. {verdicts[:2]}")
    out["record_tools"] = {"records": len(records), "trace_events": n_ev, "gate_rc": rc}
    log(f"tools phase: record tools done at {time.perf_counter() - t0:.1f} s")

    # -- c. bench_exchange on the card ---------------------------------------------------
    halo_fill.self_fill.launches = 0
    rows = be.run(ex_n, ex_n, ex_n, iters=ex_iters, quantities=4, devices=[dev])
    sync(dev)
    check(len(rows) == 5, f"tools: {len(rows)} sweep rows")
    c10 = min(10, ex_iters)
    calls = ex_iters + c10 + (ex_iters % c10)  # the timed exchanges and the warm-up's
    fills = sum(sum(1 for ph in build_plan(GridSpec(Dim3(ex_n, ex_n, ex_n), Dim3(1, 1, 1), rad),
                                           (1, 1, 1), Method.AXIS_COMPOSED).axis_phases
                    if ph.active) for _name, rad in be.sweep_radii())
    check(halo_fill.self_fill.launches == calls * fills * on_card,
          f"tools: radius sweep {halo_fill.self_fill.launches} fill launches, expected "
          f"{calls * fills * on_card}")
    for row in rows:
        log(f"tools bench_exchange sweep: {be.report_row(row)}  "
            f"({row['bytes_per_s'] / 1e9:.2f} GB/s)")
    out["sweep_gbps"] = {row["config"]: row["bytes_per_s"] / 1e9 for row in rows}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        arows, agree = be.ablate(ex_n, ex_n, ex_n, iters=ex_iters, quantities=4,
                                 devices=[dev])
    check("# skipping auto-spmd:" in buf.getvalue(), "tools: auto-spmd not reported skipped")
    by = {r_["config"].split("method=")[1]: r_ for r_ in arows}
    check(agree and sorted(by) == ["axis-composed", "direct26", "remote-dma"],
          f"tools: ablation rows {sorted(by)}, agreement {agree}")
    check([by[m]["cp_count"] for m in ("axis-composed", "direct26", "remote-dma")] == [6, 26, 0],
          "tools: ablation census columns")
    for row in arows:
        log(f"tools bench_exchange ablate (2,2,2) residents: {be.ablate_row(row)}  "
            f"({row['bytes_per_s'] / 1e9:.2f} GB/s)")
    out["ablate_gbps"] = {m: by[m]["bytes_per_s"] / 1e9 for m in by}
    out["mesh_gbps"] = {}
    for fused in (False, True):
        rdma.remote_axis.launches = fst.fused_exchange.launches = 0
        r = time_exchange(Dim3(ex_n, ex_n, ex_n), Radius.constant(2), ex_iters,
                          method=Method.REMOTE_DMA, devices=pos8, quantities=4, fused=fused)
        sync(dev)
        got = fst.fused_exchange.launches if fused else rdma.remote_axis.launches
        want = calls * (1 if fused else 3) * on_card
        check(got == want, f"tools: config 2 over 8 positions fused={fused}: {got} launches, "
              f"expected {want}")
        name = "B7 fused" if fused else "B6"
        out["mesh_gbps"][name] = r["gb_per_s"]
        log(f"tools bench_exchange config 2 over 8 positions via {name}: "
            f"{r['trimean_s'] * 1e3:.4f} ms, {r['gb_per_s']:.2f} GB/s logical "
            f"(PERF.md section 5: B6 132.69, B7 208.97 GB/s); {got} launches")
        del r
    wrows, ratio, err = be.wire_ab(ex_n, ex_n, ex_n, iters=ex_iters, quantities=4,
                                   devices=pos8, method=Method.REMOTE_DMA, wire="bfloat16")
    thr, bound = be.wire_gate("bfloat16")
    check(ratio >= thr and err["max_rel_err"] <= bound
          and len({w["cp_count"] for w in wrows}) == 1,
          f"tools: wire A/B gate: ratio {ratio}, err {err}")
    for row in wrows:
        log(f"tools bench_exchange wire A/B: {be.ablate_row(row)}  "
            f"({row['bytes_per_s'] / 1e9:.2f} GB/s)")
    log(f"tools wire A/B bf16: {ratio:.3f}x fewer wire bytes, max rel err "
        f"{err['max_rel_err']:.3e} (gate {thr:g}x, {bound:g}): PASS")
    out["wire_ab"] = {"ratio": ratio, **err,
                      "gbps": {w["config"]: w["bytes_per_s"] / 1e9 for w in wrows}}
    log(f"tools phase: bench_exchange done at {time.perf_counter() - t0:.1f} s")

    # -- d. bench_pack ----------------------------------------------------------------
    prow = bp.run(pack_n, pack_n, pack_n, radius=3, iters=pack_iters, device=dev)
    size, rad = Dim3(pack_n, pack_n, pack_n), Radius.constant(3)
    check(len(prow) == 26 and all(
        p["bytes"] == halo_rect(d, size, rad, halo=True).extent().flatten() * 4
        for p, d in zip(prow, DIRECTIONS_26)), "tools: bench_pack rows")
    log("tools bench_pack " + f"{pack_n}^3 r3 GB/s: " + ", ".join(
        f"({p['dir'][0]} {p['dir'][1]} {p['dir'][2]}) {p['gb_per_s']:.2f}" for p in prow))
    out["pack_gbps"] = {str(p["dir"]): p["gb_per_s"] for p in prow}

    # -- e. measure_overlap -------------------------------------------------------------
    trace_dir = os.path.join(tmp, "overlap")
    r = mo.run(overlap_n, overlap_n, overlap_n, radius=1, iters=overlap_iters, rounds=rounds,
               devices=pos8, weak=False, trace_dir=trace_dir)
    log(f"tools measure_overlap: {mo.csv_row(r)}  hidden_frac {r['hidden_frac']:.3f}")
    out["overlap"] = {k_: r[k_] for k_ in ("compute_s", "exchange_s", "serial_s", "overlap_s",
                                          "hidden_s", "hidden_frac")}
    if on_card:
        secs = xprof.range_seconds(trace_dir)
        sw = {k_: v for k_, v in secs.items() if kernel_base(k_) == "jacobi_sweep_kernel"}
        check(sw and all(v > 0 for v in sw.values()),
              f"tools: measure_overlap's trace has no jacobi_sweep_kernel ({sorted(secs)[:5]})")
        out["overlap"]["trace_sweep_ms"] = sum(sw.values()) * 1e3
        log(f"tools measure_overlap trace: jacobi_sweep_kernel {sum(sw.values()) * 1e3:.4f} "
            f"ms on the device; overlap.overlap "
            f"{secs.get('overlap.overlap', 0.0) * 1e3:.4f} ms")
    del r
    tmp_ctx.cleanup()
    log(f"phase 19 (tools) {time.perf_counter() - t0:.1f} s")
    return out, prof_ms


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def from_global(g: torch.Tensor, spec, mesh):
    """A global [z, y, x] tensor as a mesh's blocks (halos 0), on each
    position's device."""
    from stencil_tpu_torch.parallel import shard_blocks

    return shard_blocks(g.to(mesh.devices[0]), spec, mesh)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stencil_tpu_torch import DistributedDomain, GridSpec
    from stencil_tpu_torch.apps import astaroth as astaroth_app
    from stencil_tpu_torch.apps import bench_fill
    from stencil_tpu_torch.apps import jacobi3d
    from stencil_tpu_torch.astaroth.equations import Constants
    from stencil_tpu_torch.astaroth.integrate import FIELDS, inv_ds_of
    from stencil_tpu_torch.geometry import Dim3, Radius, Rect3
    from stencil_tpu_torch.ops import _native, halo_fill, stencil_kernels as sk
    from stencil_tpu_torch.ops import astaroth_substep as asub
    from stencil_tpu_torch.ops import fused_stencil as fst
    from stencil_tpu_torch.ops import persistent_stencil as pst
    from stencil_tpu_torch.parallel import Method
    from stencil_tpu_torch.plan.ir import build_plan
    from stencil_tpu_torch.ops.jacobi import (INIT_TEMP, jacobi_reference, make_jacobi_loop,
                                              sphere_masks, sphere_sel_blocks)
    from stencil_tpu_torch.parallel import HaloExchange
    from stencil_tpu_torch.utils.roofline import bound_ms, issue_ms
    from stencil_tpu_torch.utils.timer import cuda_time_ms as time_ms

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    log(f"chip_smoke: torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # -- 1. build ---------------------------------------------------------------
    info = _native.build_all()
    log(f"build: {info.seconds:.1f} s ({', '.join(n for n, b in info.built.items() if b) or 'cached'})")
    for name, text in info.ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                log(f"ptxas {name}: {line.strip()}")
    ms_lib = _native.lib("jacobi_multistep")
    for item, tname in ((4, "fp32"), (8, "fp64")):
        for k in range(1, sk.MULTISTEP_KMAX + 1):
            check(ms_lib.jacobi_multistep_smem_bytes(k, item) == sk.multistep_smem_bytes(k, item),
                  f"multistep {tname} smem formula differs from the kernel's at k={k}")
            for mb in (False, True):
                mi = sk.multistep_info(0, k, mb, item)
                check(mi["threads"] == sk.multistep_shape(k, item)["threads"]
                      and mi["blocks_per_sm"] >= 1
                      and mi["smem_bytes"] == sk.multistep_smem_bytes(k, item),
                      f"multistep {tname} k={k} mb={mb}: launch shape {mi} differs from the "
                      "wrapper's")
                # fp32 at the planner's depth; fp64 at every depth
                check((item == 4 and k != sk.MULTISTEP_KPLAN) or mi["local_bytes"] == 0,
                      f"multistep {tname} k={k} mb={mb} spills: {mi}")
                log(f"jacobi_multistep {tname} k={k} {'deep-halo' if mb else 'single-block'}: "
                    f"{mi['regs']} registers, {mi['local_bytes']} bytes of spill, "
                    f"{mi['blocks_per_sm']} block(s) of {mi['threads']} threads per SM, "
                    f"{mi['smem_bytes']} bytes of shared memory")
    # the fp32 instantiation at the planner's depth, as its redesign built it
    mi = sk.multistep_info(0, sk.MULTISTEP_KPLAN, False, 4)
    check((mi["regs"], mi["threads"], mi["blocks_per_sm"]) == FP32_BUILDS["jacobi_multistep"],
          f"multistep fp32 k={sk.MULTISTEP_KPLAN}: {mi}, not (registers, threads, blocks) "
          f"{FP32_BUILDS['jacobi_multistep']}")
    fi, fsh = fst.fused_info(0), fst.fused_shape()
    check(fi["threads"] == fsh["threads"] and fi["smem_bytes"] == fsh["smem_bytes"]
          and fi["blocks_per_sm"] >= 2 and fi["local_bytes"] == 0,
          f"fused step kernel: launch shape {fi} differs from the wrapper's {fsh}, holds fewer "
          "than 2 blocks per SM, or spills")
    check((fi["regs"], fi["threads"], fi["blocks_per_sm"]) == FP32_BUILDS["fused_jacobi"],
          f"fused step kernel: {fi}, not (registers, threads, blocks) "
          f"{FP32_BUILDS['fused_jacobi']}")
    log(f"fused_jacobi: {fi['regs']} registers, {fi['local_bytes']} bytes of spill, "
        f"{fi['blocks_per_sm']} block(s) of {fi['threads']} threads per SM, "
        f"{fi['smem_bytes']} bytes of shared memory")
    # B1 on the same body (sweep_runs.cuh's flex_tile): two blocks of 352
    # threads per SM and no spill; B8 keeps three
    for item, tname in ((4, "fp32"), (8, "fp64")):
        si = sk.sweep_info(0, item)
        check(si["threads"] == sk.SWEEP_THREADS and si["smem_bytes"] == sk.SWEEP_SMEM
              and si["blocks_per_sm"] >= sk.SWEEP_MIN_BLOCKS and si["local_bytes"] == 0
              and fi["blocks_per_sm"] >= fst.FUSED_MIN_BLOCKS,
              f"sweep kernel {tname}: launch shape {si} differs from the wrapper's, holds fewer "
              f"than {sk.SWEEP_MIN_BLOCKS} blocks per SM, or spills; or the fused step holds "
              f"fewer than {fst.FUSED_MIN_BLOCKS} (fused step: {fi})")
        check(item == 8 or (si["regs"], si["threads"], si["blocks_per_sm"])
              == FP32_BUILDS["jacobi_sweep"],
              f"sweep kernel fp32: {si}, not (registers, threads, blocks) "
              f"{FP32_BUILDS['jacobi_sweep']}")
        log(f"jacobi_sweep {tname} (B1, the task-table walk): {si['regs']} registers, "
            f"{si['local_bytes']} bytes of spill, {si['blocks_per_sm']} block(s) of "
            f"{si['threads']} threads per SM, {si['smem_bytes']} bytes of shared memory; "
            f"{sk.sweep_blocks_in_flight(0, item)} resident blocks")
    wire_names = {0: "unnarrowed", 1: "bf16", 2: "fp16", 3: "fp8 e4m3", 4: "fp32",
                  5: "fp8 e5m2", halo_fill.SOFT_WIRE: "software formats (SOFT)"}
    for code in (1, 2, 3, 5, halo_fill.SOFT_WIRE):
        wi = fst.fused_info(0, code)
        check(wi["threads"] == fsh["threads"] and wi["smem_bytes"] == fsh["smem_bytes"]
              and wi["blocks_per_sm"] >= 1 and wi["local_bytes"] == 0,
              f"fused step kernel through the {wire_names[code]} wire: launch shape {wi} "
              "(or it spills)")
        log(f"fused_jacobi through the {wire_names[code]} wire: {wi['regs']} registers, "
            f"{wi['local_bytes']} bytes of spill, {wi['blocks_per_sm']} block(s) per SM")
    regs = (ctypes.c_int * 2)()
    for elem, codes in ((4, (0, 1, 2, 3, 5, halo_fill.SOFT_WIRE)),
                        (8, (0, 4, 1, 2, 3, 5, halo_fill.SOFT_WIRE))):
        for code in codes:
            _native.check(_native.lib("remote_axis").remote_axis_info(elem, code, regs),
                          "remote_axis_info")
            check(regs[1] == 0 and (code != 0 or regs[0] == ROW_MOVE_REGS),
                  f"the {8 * elem}-bit row-move body through the {wire_names[code]} wire: "
                  f"{regs[0]} registers, {regs[1]} bytes of spill (the unnarrowed body holds "
                  f"{ROW_MOVE_REGS}; no instantiation spills)")
            log(f"row-move body (remote_axis, fused_exchange), {8 * elem}-bit words, "
                f"{wire_names[code]}: {regs[0]} registers, {regs[1]} bytes of spill")
    in_flight = fi["blocks_per_sm"] * torch.cuda.get_device_properties(0).multi_processor_count
    fj_lib = _native.lib("fused_jacobi")
    for size, part, r, aligned in (((512,) * 3, (1, 1, 1), 1, True),
                                   ((512,) * 3, (2, 2, 2), 1, True),
                                   ((200, 100, 61), (1, 1, 1), 1, False),
                                   ((513, 37, 19), (1, 1, 1), 1, False),
                                   ((24, 20, 16), (2, 1, 1), 1, True)):
        bs = GridSpec(Dim3(*size), Dim3(*part), Radius.constant(r), aligned=aligned).block_spec()
        npos = part[0] * part[1] * part[2]
        got = fj_lib.fused_jacobi_zchunks(bs.base.z, bs.base.y, bs.base.x,
                                          bs.compute_offset().x, npos, in_flight)
        check(got == fst.fused_zchunks(bs, npos, in_flight),
              f"fused z chunks of {size} over {part}: kernel {got}, python "
              f"{fst.fused_zchunks(bs, npos, in_flight)}")
        log(f"fused_jacobi {'x'.join(map(str, size))} over {part}: {got} z chunk(s) per tile "
            f"column for {in_flight} resident blocks")
    pj_lib = _native.lib("persistent_jacobi")
    depths = (ctypes.c_int * 16)()
    for k in range(1, 13):
        n = pj_lib.persistent_jacobi_passes(k, depths, 16)
        check(list(depths[:n]) == pst.chunk_passes(k),
              f"persistent chunk passes at k={k}: kernel {list(depths[:n])}, "
              f"python {pst.chunk_passes(k)}")
    for k in list(range(2, pst.ONCHIP_KMAX + 1)) + [8]:
        blocks = ctypes.c_int(0)
        _native.check(pj_lib.persistent_jacobi_blocks_per_sm(k, 0, ctypes.byref(blocks)),
                      "persistent_jacobi_blocks_per_sm")
        log(f"persistent_jacobi k={k}: passes {pst.chunk_passes(k)}, "
            f"{pj_lib.persistent_jacobi_smem_bytes(k)} bytes of dynamic shared memory, "
            f"{blocks.value} resident block(s) of {pj_lib.persistent_jacobi_threads(k)} threads "
            "per SM")
    k512 = sk.plan_multistep_depth(min(sk.TEMPORAL_K_CAP, (512 - 1) // 2))
    k768 = sk.plan_multistep_depth(min(sk.TEMPORAL_K_CAP, (768 - 1) // 2))
    log(f"multistep depth planner: k={k512} at 512^3, k={k768} at 768^3 "
        f"({sk.multistep_smem_bytes(k512)} bytes of shared memory per block)")

    errs = {"jacobi_sweep": 0.0, "jacobi_multistep": 0.0, "self_fill": 0.0,
            "astaroth_substep": 0.0, "fused_jacobi": 0.0, "persistent_jacobi": 0.0}

    def rand_block(spec, seed, dtype=torch.float32):
        gen.manual_seed(seed)
        p = spec.padded()
        return torch.rand((1, 1, 1, p.z, p.y, p.x), generator=gen, device=dev).to(dtype)

    def sel_block(spec):
        return sphere_sel_blocks(spec, dev)

    def rand_sel(spec, seed, lo=0, hi=3):
        gen.manual_seed(seed)
        p = spec.padded()
        return torch.randint(lo, hi, (1, 1, 1, p.z, p.y, p.x), generator=gen, device=dev,
                             dtype=torch.int32)

    def b1_form(run, plain, spec, rects, sel_range=None, blocks=None, reps=20, plain_reps=3):
        """:func:`b1_times` of a form sweeping ``rects`` of ``blocks``
        blocks of ``spec``, sel on ``sel_range``."""
        return b1_times(time_ms, dev, run, plain, sk.sweep_bytes(spec, rects, sel_range, blocks),
                        reps, plain_reps)

    # -- 2. kernels against their plain versions ----------------------------
    sweep_cases = [
        ("512^3 r1 aligned", GridSpec(Dim3(512, 512, 512), Dim3(1, 1, 1), Radius.constant(1)),
         (True, True, True)),
        ("100x70x50 r1 unaligned", GridSpec(Dim3(100, 70, 50), Dim3(1, 1, 1), Radius.constant(1),
                                           aligned=False), (True, True, True)),
        ("256x64x40 tight-x", GridSpec(Dim3(256, 64, 40), Dim3(1, 1, 1),
                                       Radius.constant(1).without_x()), (True, True, True)),
        ("33x21x13 r2 z/x halos read", GridSpec(Dim3(33, 21, 13), Dim3(1, 1, 1),
                                                Radius.constant(2)), (False, True, False)),
        ("512^3 tight-x all-wrap", GridSpec(Dim3(512, 512, 512), Dim3(1, 1, 1),
                                            Radius.constant(1).without_x()), (True, True, True)),
        ("67x45x29", GridSpec(Dim3(67, 45, 29), Dim3(1, 1, 1), Radius.constant(1)),
         (True, True, True)),
        ("130x70x40", GridSpec(Dim3(130, 70, 40), Dim3(1, 1, 1), Radius.constant(1)),
         (True, True, True)),
    ]
    # each with random sel codes in [-1, 4) on every plane and on planes
    # 3..8 of the region, and with the spheres on their planes
    for i, (label, spec, wrap) in enumerate(sweep_cases):
        curr = rand_block(spec, 10 + i)
        z0 = spec.compute_offset().z
        for what, sel, rng in (("random sel", rand_sel(spec, 20 + i, -1, 4), None),
                               ("random sel on 6 planes", rand_sel(spec, 30 + i, -1, 4),
                                (z0 + 3, z0 + 9)),
                               ("spheres on their planes", sel_block(spec), sk.sel_z_range(spec))):
            got = sk.sweep(curr, torch.zeros_like(curr), sel, spec, wrap, rng)
            want = sk.sweep_plain(curr, torch.zeros_like(curr), sel, spec, wrap, rng)
            torch.cuda.synchronize()
            errs["jacobi_sweep"] = max(errs["jacobi_sweep"], max_abs(got, want))
            check(torch.equal(got, want), f"sweep {label}, {what}: kernel != plain")
        log(f"sweep {label} (tile {sk.sweep_tile(spec.base.x, spec.base.y, spec.compute_offset().x)}"
            f"): equal with random sel, random sel on 6 planes and the spheres on their planes")
    del curr, sel, got, want

    # every depth on shapes ragged against the 64-wide tile and both tile
    # heights (their shallow depths run several z chunks, their deep ones
    # one); the campaign's 32^3 tenant; tight-x (no x halo); 512^3 at the
    # planner's depth
    one = Dim3(1, 1, 1)
    ms_cases = [(f"200x100x60 k={k}", GridSpec(Dim3(200, 100, 60), one, Radius.constant(1)), k)
                for k in sorted({2, 5, k512, sk.MULTISTEP_KMAX})]
    for size in ((67, 45, 29), (130, 70, 40)):
        ragged = GridSpec(Dim3(*size), one, Radius.constant(1))
        ms_cases += [(f"{size[0]}x{size[1]}x{size[2]} k={k}", ragged, k)
                     for k in range(1, sk.MULTISTEP_KMAX + 1)]
    ms_cases += [(f"32^3 tenant k={k}", GridSpec(Dim3(32, 32, 32), one, Radius.constant(1),
                                                 aligned=False), k)
                 for k in range(1, sk.MULTISTEP_KMAX + 1)]
    ms_cases += [(f"128x40x30 tight-x k={k}", GridSpec(Dim3(128, 40, 30), one,
                                                       Radius.constant(1).without_x()), k)
                 for k in (2, 3, 5)]
    ms_cases.append((f"512^3 k={k512}", sweep_cases[0][1], k512))
    chunk_counts = set()
    for i, (label, spec, k) in enumerate(ms_cases):
        curr = rand_block(spec, 20 + i)
        got = sk.multistep(curr, torch.zeros_like(curr), spec, k)
        want = sk.multistep_plain(curr, torch.zeros_like(curr), spec, k)
        torch.cuda.synchronize()
        errs["jacobi_multistep"] = max(errs["jacobi_multistep"], max_abs(got, want))
        check(torch.equal(got, want), f"multistep {label}: kernel != plain")
        zc = sk.multistep_zchunks(spec, k, sk.multistep_blocks_in_flight(dev, k))
        chunk_counts.add(min(zc, 2))
        log(f"multistep {label}: equal (zchunks {zc})")
    check(chunk_counts == {1, 2}, "multistep checks ran only one z-chunk regime")

    def asym_radius():
        r = Radius.constant(0)
        for d, v in (((-1, 0, 0), 1), ((1, 0, 0), 3), ((0, -1, 0), 2), ((0, 1, 0), 1),
                     ((0, 0, -1), 3), ((0, 0, 1), 2)):
            r.set_dir(d, v)
        return r

    for rlabel, radius in (("r1", Radius.constant(1)), ("r3", Radius.constant(3)),
                           ("asym", asym_radius())):
        spec = GridSpec(Dim3(130, 70, 40), Dim3(1, 1, 1), radius)
        for dtype in (torch.float32, torch.float64):
            for axis in halo_fill.AXIS_ORDER:
                blocks = [rand_block(spec, 30 + q, dtype) for q in range(4)]
                got = halo_fill.self_fill([b.clone() for b in blocks], spec, axis)
                want = halo_fill.self_fill_plain([b.clone() for b in blocks], spec, axis)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    errs["self_fill"] = max(errs["self_fill"], max_abs(g, w))
                    check(torch.equal(g, w), f"fill {rlabel} {dtype} {axis}: kernel != plain")
        log(f"fill {rlabel} x/y/z nq=4 fp32+fp64: equal")

    # shapes that reach the kernel's scalar and vector paths: odd padded x
    # (unaligned layout) with asymmetric radii at nq 1 and 16, the same with
    # every block one word off its allocation's alignment, row ends of 8 and
    # 16 bytes (r2, r4), a radius wider than a 16-byte vector (r5), and a
    # z-stack of three blocks
    def fill_case(label, spec, dtype, nq, axes=halo_fill.AXIS_ORDER, z_stack=1, offset=0):
        p = spec.padded()
        numel = z_stack * p.z * p.y * p.x
        for axis in axes:
            qs = []
            for q in range(nq):
                gen.manual_seed(60 + q)
                buf = torch.rand(numel + offset, generator=gen, device=dev).to(dtype)
                qs.append(buf[offset:].view(z_stack, p.z, p.y, p.x))
            align = min(min(t.data_ptr() & -t.data_ptr() for t in qs), 16)
            vec = halo_fill.fill_layout(spec, axis, qs[0].element_size(), z_stack, align).vec
            widths.add((qs[0].element_size(), vec))
            got = halo_fill.self_fill([t.clone() for t in qs], spec, axis, z_stack=z_stack)
            want = halo_fill.self_fill_plain([t.clone() for t in qs], spec, axis)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                errs["self_fill"] = max(errs["self_fill"], max_abs(g, w))
                check(torch.equal(g, w), f"fill {label} {dtype} nq={nq} {axis}: kernel != plain")
        log(f"fill {label} {dtype} nq={nq} {'/'.join(axes)}: equal")

    widths = set()
    odd = GridSpec(Dim3(67, 33, 21), Dim3(1, 1, 1), asym_radius(), aligned=False)
    for dtype in (torch.float32, torch.float64):
        for nq in (1, 16):
            fill_case("67x33x21 unaligned asym", odd, dtype, nq)
            fill_case("67x33x21 unaligned asym, one word off", odd, dtype, nq, offset=1)
        for r in (2, 4, 5):
            fill_case(f"64^3 r{r}", GridSpec(Dim3(64, 64, 64), Dim3(1, 1, 1), Radius.constant(r)),
                      dtype, 4)
    fill_case("z-stack of 3, 64x40x90 (1,1,3) r3",
              GridSpec(Dim3(64, 40, 90), Dim3(1, 1, 3), Radius.constant(3)), torch.float64, 4,
              ("x", "y"), z_stack=3)
    check(widths >= {(4, 1), (4, 2), (4, 4), (8, 1), (8, 2)},
          f"fill checks reached only the (element, vector) widths {sorted(widths)}")
    # the kernel refuses a vector width that does not divide the layout
    spec64 = GridSpec(Dim3(64, 64, 64), Dim3(1, 1, 1), Radius.constant(3))
    lay = halo_fill.fill_layout(spec64, "x", 4)
    blk = rand_block(spec64, 61)
    rc = _native.lib("self_fill").self_fill_launch(
        (ctypes.c_void_p * 1)(blk.data_ptr()), 1, 4, 1,
        (ctypes.c_longlong * 6)(*[v for run in lay.runs for v in run]), lay.count, lay.stride,
        4, _native.stream_ptr(dev))
    check(rc == 1, f"fill with a 16-byte width on 12-byte row ends returned {rc}, "
                   "not cudaErrorInvalidValue")
    log(f"fill widths reached (bytes per word, words per access): {sorted(widths)}; "
        "a misfit width is refused")
    del blk

    # timings at the main path's shapes
    spec512 = sweep_cases[0][1]
    curr, sel = rand_block(spec512, 1), sel_block(spec512)
    nxt = torch.zeros_like(curr)
    cells = 512 ** 3
    timings = {}
    # B1 on one block as the default path's tail calls it (sel on the
    # spheres' planes), and reading sel on every plane; the tight-x layout
    rg512 = sk.sel_z_range(spec512)
    whole512 = [Rect3(spec512.compute_offset(), spec512.compute_offset() + spec512.base)]
    timings["jacobi_sweep"] = b1_form(
        lambda: sk.sweep(curr, nxt, sel, spec512, (True,) * 3, rg512),
        lambda: sk.sweep_plain(curr, nxt, sel, spec512, (True,) * 3, rg512), spec512, whole512,
        rg512)
    timings["jacobi_sweep"]["extra"]["every_plane_ms"] = time_ms(
        lambda: sk.sweep(curr, nxt, sel, spec512), 20, graph=True)
    b1_log("jacobi_sweep", timings["jacobi_sweep"], "512^3 one block, sel on its planes")
    log(f"time jacobi_sweep 512^3 one block, sel on every plane: "
        f"{timings['jacobi_sweep']['extra']['every_plane_ms']:.4f} ms per launch")
    spec_tx = sweep_cases[4][1]
    ctx, stx = rand_block(spec_tx, 2), sel_block(spec_tx)
    ntx = torch.zeros_like(ctx)
    rgtx = sk.sel_z_range(spec_tx)
    ttx = b1_form(lambda: sk.sweep(ctx, ntx, stx, spec_tx, (True,) * 3, rgtx),
                  lambda: sk.sweep_plain(ctx, ntx, stx, spec_tx, (True,) * 3, rgtx), spec_tx,
                  [Rect3(spec_tx.compute_offset(), spec_tx.compute_offset() + spec_tx.base)],
                  rgtx, plain_reps=1)
    b1_log("jacobi_sweep", ttx, "512^3 tight-x all-wrap, sel on its planes")
    timings["jacobi_sweep"]["extra"]["tight_x_ms"] = ttx["ms"]
    del ctx, stx, ntx, ttx
    timings["jacobi_multistep"] = dict(
        ms=time_ms(lambda: sk.multistep(curr, nxt, spec512, k512), 5, warmup=1, graph=True),
        plain_ms=time_ms(lambda: sk.multistep_plain(curr, nxt, spec512, k512), 1, warmup=1),
        bound=bound_ms(2 * 4 * cells, 6 * k512 * cells), library_ms=None)
    del curr, nxt, sel

    # the fill per axis (apps/bench_fill.py): the 512^3 r3 x4 exchange's, its
    # (1,1,2) z-stack form and Astaroth's 256^3 r3 x8 fp64, each beside its
    # bytes bound, its sector floor and Tensor.copy_ of the same slabs, with
    # the halos partly in L2 (two sets of quantities alternating: evicted)
    fill_rows = []
    for label, size, part, r, nq, dtype, axes in bench_fill.CASES:
        fill_rows += bench_fill.measure(label, bench_fill.case_spec(size, part, r), nq, dtype,
                                        axes, gen, dev)
    for row in fill_rows:
        log(f"time self_fill {row['case']} {row['axis']}: {row['ms']:.4f} ms per launch "
            f"(L2 evicted {row['ms_cold']:.4f}; bound {row['bound_ms']:.4f} ms by bytes, "
            f"sector floor {row['sector_ms']:.4f}, Tensor.copy_ {row['copy_ms']:.4f}; "
            f"{row['vec']} words per access)")
    spec_ex = bench_fill.case_spec(512, (1, 1, 1), 3)
    qs = [rand_block(spec_ex, 40 + q) for q in range(4)]

    def plain_fills():
        for axis in halo_fill.AXIS_ORDER:
            halo_fill.self_fill_plain(qs, spec_ex, axis)

    def per_axis(case):
        rows = [row for row in fill_rows if row["case"] == case]
        mean = lambda key: sum(row[key] for row in rows) / len(rows)  # noqa: E731
        return mean, {"axes": {row["axis"]: {k: row[k] for k in (
            "ms", "ms_cold", "copy_ms", "bound_ms")} for row in rows}}

    mean, extra = per_axis(bench_fill.CASES[0][0])
    timings["self_fill"] = dict(
        ms=mean("ms"), plain_ms=time_ms(plain_fills, 5) / 3, bound=(mean("bound_ms"), "bytes"),
        library_ms=mean("copy_ms"), extra=extra)
    del qs
    for name, t in timings.items():
        log(f"time {name}: {t['ms']:.4f} ms per launch (plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound'][0]:.4f} ms by {t['bound'][1]}"
            + (f", Tensor.copy_ {t['library_ms']:.4f} ms" if t["library_ms"] else "") + ")")

    # -- 3. the main path: jacobi3d at 512^3 ------------------------------------
    launches = {}
    sk.sweep.launches = sk.multistep.launches = halo_fill.self_fill.launches = 0
    r = jacobi3d.run(512, 512, 512, iters=50, weak=False, chunk=25)
    torch.cuda.synchronize()
    launches["jacobi_sweep"], launches["jacobi_multistep"] = sk.sweep.launches, sk.multistep.launches
    check(r["temporal_k"] == k512, f"jacobi3d ran k={r['temporal_k']}, planner says {k512}")
    # 3 chunks of 25 steps (the warm-up's and two timed): 25 // k passes and
    # 25 % k sweeps each
    want3 = {"jacobi_sweep": 3 * (25 % k512), "jacobi_multistep": 3 * (25 // k512)}
    check(launches == want3, f"jacobi3d 512^3: launches {launches}, expected {want3}")
    log(jacobi3d.csv_row(r))
    log(f"jacobi3d 512^3: {r['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), "
        f"{r['mcells_per_s_per_dev']:.1f} Mcells/s, multistep k={r['temporal_k']}, "
        f"launches {launches}")
    hot, cold = (torch.from_numpy(m).to(dev) for m in sphere_masks(Dim3(512, 512, 512)))

    def check_field(r, label):
        """The final field of a 512^3 run: finite, in [COLD, HOT], spheres held."""
        dd, h = r["domain"], r["handle"]
        off = dd.spec.compute_offset()
        comp = dd.get_curr(h)[0, 0, 0, off.z:off.z + 512, off.y:off.y + 512,
                              off.x:off.x + 512]
        check(bool(torch.isfinite(comp).all()), f"{label}: non-finite values")
        check(float(comp.min()) >= 0.0 and float(comp.max()) <= 1.0,
              f"{label}: values outside [COLD, HOT]")
        check(bool((comp[hot] == 1.0).all()) and bool((comp[cold] == 0.0).all()),
              f"{label}: spheres not held")

    check_field(r, "jacobi3d 512^3")
    del r

    # 2k+2 steps at 512^3 through the kernels (2 multistep passes + 2 sweeps) and
    # through the plain versions, from the same random field
    ex = HaloExchange(spec512)
    loop = make_jacobi_loop(ex, 2 * k512 + 2)
    sel = sel_block(spec512)
    start = rand_block(spec512, 3)
    c, n = loop(start.clone(), torch.zeros_like(start), sel)
    pc, pn = start.clone(), torch.zeros_like(start)
    for _ in range(2):
        pc, pn = sk.multistep_plain(pc, pn, spec512, k512), pc
    for _ in range(2):
        pc, pn = sk.sweep_plain(pc, pn, sel, spec512), pc
    torch.cuda.synchronize()
    check(torch.equal(c, pc) and torch.equal(n, pn), "jacobi 512^3: kernel path != plain path")
    log(f"jacobi 512^3 {2 * k512 + 2} steps: kernel path == plain path")
    del ex, loop, sel, start, c, n, pc, pn

    # a small run against the float64 numpy reference (uniform 0.5 start)
    small = (48, 40, 36)
    rs = jacobi3d.run(*small, iters=10, weak=False, warmup=0)
    got = rs["domain"].get_curr_global(rs["handle"])
    want = jacobi_reference(np.full(small[::-1], INIT_TEMP, np.float32),
                            sphere_masks(Dim3(*small)), 10)
    err = float(np.abs(got - want).max())
    check(err < 1e-5, f"jacobi3d {small}: max |port - float64 reference| = {err}")
    log(f"jacobi3d {small} 10 steps vs float64 numpy reference: max abs err {err:.3e}")

    # -- 4. the exchange path: 512^3, radius 3, four fp32 quantities -----------
    dd = DistributedDomain(512, 512, 512)
    dd.set_radius(3)
    hs = [dd.add_data(f"q{i}", "float32") for i in range(4)]
    dd.realize()
    for i, hq in enumerate(hs):
        dd.set_curr(hq, rand_block(dd.spec, 50 + i))
    before = [dd.get_curr(hq).clone() for hq in hs]
    halo_fill.self_fill.launches = 0
    loop = dd.exchange_loop(1)
    loop(dd.curr_state())
    torch.cuda.synchronize()
    launches["self_fill"] = halo_fill.self_fill.launches
    check(launches["self_fill"] == 3, f"exchange ran {launches['self_fill']} fill launches, not 3")
    for axis in halo_fill.AXIS_ORDER:
        halo_fill.self_fill_plain(before, dd.spec, axis)
    torch.cuda.synchronize()
    for hq, b in zip(hs, before):
        check(torch.equal(dd.get_curr(hq), b), "exchange 512^3 r3: kernel != plain fill")
    del before
    loop10 = dd.exchange_loop(10)
    ex_ms = time_ms(lambda: loop10(dd.curr_state()), 3, warmup=1) / 10
    lib_ms = timings["self_fill"]["library_ms"] * 3
    nbytes = dd.exchange_bytes_for_method(dd.halo_exchange.method)
    log(f"exchange 512^3 r3 x4 fp32: {ex_ms:.4f} ms, {nbytes / ex_ms / 1e6:.2f} GB/s logical "
        f"({nbytes} bytes; {dd.exchange_bytes_moved()} moved); Tensor.copy_ slabs "
        f"{lib_ms:.4f} ms = {nbytes / lib_ms / 1e6:.2f} GB/s")
    del dd

    # -- 5. astaroth: the RK3 substep kernel and the MHD app at 256^3 ----------
    ainfo = astaroth_app.load()
    consts, ids = Constants.from_info(ainfo), inv_ds_of(ainfo)
    # each instantiation's launch shape, held to the wrapper's mirror
    for dtype in (torch.float64, torch.float32):
        item = torch.empty((), dtype=dtype).element_size()
        for s in (0, 1):
            si = asub.substep_info(0, item, s)
            check(si["smem_bytes"] == asub.substep_smem_bytes(item)
                  and si["threads"] == asub.substep_threads(),
                  f"astaroth_substep {dtype} stage {s}: kernel launch shape {si} differs from "
                  "the wrapper's")
            log(f"astaroth_substep {dtype} stage {s}: {si['regs']} registers, "
                f"{si['local_bytes']} local bytes per thread, {si['blocks_per_sm']} block(s) of "
                f"{si['threads']} threads per SM ({si['blocks_per_sm'] * si['threads'] // 32} "
                f"warps), {si['smem_bytes']} bytes of dynamic shared memory")

    def held(label, spec, curr8, out8, stages, dt):
        """Run ``stages`` through the kernel and through the plain version
        from the same out blocks; check every block torch.equal (both
        evaluate the same operations in the same order)."""
        ok = [o.clone() for o in out8]
        op = [o.clone() for o in out8]
        for s in stages:
            asub.substep(curr8, ok, spec, consts, ids, s, dt)
            asub.substep_plain(curr8, op, spec, consts, ids, s, dt)
        torch.cuda.synchronize()
        for got, want in zip(ok, op):
            errs["astaroth_substep"] = max(errs["astaroth_substep"], max_abs(got, want))
        check(all(torch.equal(a, b) for a, b in zip(ok, op)),
              f"astaroth_substep {label}: kernel != plain version "
              f"(max abs err {errs['astaroth_substep']:.3e})")
        log(f"astaroth_substep {label}: equal")

    # several z planes per block (64^3), one (40x24x20, 33x13x7), ragged
    # x / y / z with a short last chunk (200x100x61), and radius 4
    for size, r in (((64, 64, 64), 3), ((40, 24, 20), 3), ((33, 13, 7), 3),
                    ((200, 100, 61), 3), ((48, 40, 36), 4)):
        spec = GridSpec(Dim3(*size), Dim3(1, 1, 1), Radius.constant(r))
        for dtype in (torch.float64, torch.float32):
            item = torch.empty((), dtype=dtype).element_size()
            zc = asub.substep_zchunk(spec, asub.substep_blocks_in_flight(dev, item, 1))
            curr8 = [rand_block(spec, 60 + f, dtype).view(spec.block_shape_zyx()) * 0.1
                     for f in range(8)]
            out8 = [rand_block(spec, 70 + f, dtype).view(spec.block_shape_zyx()) * 0.1
                    for f in range(8)]
            for s in range(3):
                held(f"{size} r{r} {dtype} stage {s} (z chunks of {zc})", spec, curr8, out8,
                     (s,), 0.1)

    # at 256^3 each block marches the whole z extent: one iteration from the
    # app's init at the app's dt, and random fields at dt 0.1, through both
    # versions in both dtypes
    for dtype in ("float64", "float32"):
        dd, handles = astaroth_app.make_domain(ainfo, dtype)
        spec256 = dd.spec
        state = {k: dd.get_curr(handles[k]) for k in FIELDS}
        dd.halo_exchange(state)
        curr8 = [state[k].view(spec256.block_shape_zyx()) for k in FIELDS]
        held(f"256^3 {dtype} app init, stages 0-2", spec256, curr8,
             [torch.zeros_like(t) for t in curr8], (0, 1, 2), 1e-8)
        del dd, state, curr8
        tdt = getattr(torch, dtype)
        curr8 = [rand_block(spec256, 80 + f, tdt).view(spec256.block_shape_zyx()) * 0.1
                 for f in range(8)]
        out8 = [rand_block(spec256, 90 + f, tdt).view(spec256.block_shape_zyx()) * 0.1
                for f in range(8)]
        held(f"256^3 {dtype} random, stages 0-2", spec256, curr8, out8, (0, 1, 2), 0.1)
        del curr8, out8

    # the main path: apps.astaroth.run at the conf's 256^3, fp64 then fp32
    for dtype in ("float64", "float32"):
        asub.substep_tasks.launches = asub.substep_tasks.shells = 0
        halo_fill.self_fill.launches = 0
        ra = astaroth_app.run(iters=10, dtype=dtype)
        torch.cuda.synchronize()
        n_sub, n_fill = asub.substep_tasks.launches, halo_fill.self_fill.launches
        it = ra["iters_run"]
        # warm-up + timed iterations, 3 stages (one task each: the one block)
        # and one exchange each; plus one timed exchange after each
        # (one-iteration) chunk
        check(n_sub == 3 * (it + 1) and asub.substep_tasks.shells == 0,
              f"astaroth {dtype}: {n_sub} substep launches ({asub.substep_tasks.shells} of "
              f"shells), expected {3 * (it + 1)} (none)")
        check(n_fill == 3 * (it + 1) + 3 * it, f"astaroth {dtype}: {n_fill} fill launches, "
              f"expected {3 * (2 * it + 1)}")
        for k in FIELDS:
            g = ra["domain"].get_curr_global(ra["handles"][k])
            check(g.shape == (256, 256, 256) and bool(np.isfinite(g).all()),
                  f"astaroth {dtype} {k}: not finite or wrong shape")
        if dtype == "float64":
            launches["astaroth_substep"] = n_sub
        log(astaroth_app.csv_row(ra))
        log(f"astaroth 256^3 {dtype}: {ra['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), "
            f"{ra['mcells_per_s']:.1f} Mcells/s, exchange {ra['exch_trimean_s'] * 1e3:.4f} ms, "
            f"launches substep {n_sub} fill {n_fill}")
        del ra

    # a small fp64 run on the card against the same run on the CPU (the
    # plain versions, which tests/test_torch_astaroth.py holds to stencil_tpu)
    rg = astaroth_app.run(iters=3, nx=32, dt=1e-5)
    rc = astaroth_app.run(iters=3, nx=32, dt=1e-5, device="cpu")
    small_err = 0.0
    for k in FIELDS:
        a = rg["domain"].get_curr_global(rg["handles"][k])
        b = rc["domain"].get_curr_global(rc["handles"][k])
        small_err = max(small_err, float(np.abs(a - b).max() / np.abs(b).max()))
    check(small_err <= 1e-10, f"astaroth 32^3 card vs CPU: rel err {small_err:.3e}")
    log(f"astaroth 32^3 fp64 3 iterations, card vs CPU: max rel err {small_err:.3e}")
    del rg, rc

    # per-launch time at 256^3: stage 0 once and stages 1-2 twice per iteration
    for dtype in (torch.float64, torch.float32):
        curr8 = [rand_block(spec256, 80 + f, dtype).view(spec256.block_shape_zyx()) * 0.1
                 for f in range(8)]
        out8 = [rand_block(spec256, 90 + f, dtype).view(spec256.block_shape_zyx()) * 0.1
                for f in range(8)]
        st = [time_ms(lambda s=s: asub.substep(curr8, out8, spec256, consts, ids, s, 1e-8),
                      6, warmup=1, graph=True) for s in (0, 1)]
        pl = [time_ms(lambda s=s: asub.substep_plain(curr8, out8, spec256, consts, ids, s, 1e-8),
                      1, warmup=1) for s in (0, 1)]
        item = torch.empty((), dtype=dtype).element_size()
        nbytes = (asub.stage_bytes(spec256, item, 0) + 2 * asub.stage_bytes(spec256, item, 1)) / 3
        flops = (asub.FLOPS_PER_CELL[0] + 2 * asub.FLOPS_PER_CELL[1]) / 3 * spec256.base.flatten()
        t = dict(ms=(st[0] + 2 * st[1]) / 3, plain_ms=(pl[0] + 2 * pl[1]) / 3,
                 bound=bound_ms(nbytes, flops, dtype), library_ms=None)
        for s, b in ((0, 0), (1, 1)):
            sops = asub.FLOPS_PER_CELL[s] * spec256.base.flatten()
            sb = bound_ms(asub.stage_bytes(spec256, item, s), sops, dtype)
            log(f"time astaroth_substep 256^3 {dtype} stage {s}: {st[b]:.4f} ms "
                f"(plain {pl[b]:.4f} ms, bound {sb[0]:.4f} ms by {sb[1]}, unfused issue "
                f"{issue_ms(sops, dtype):.4f} ms)")
        if dtype == torch.float64:
            timings["astaroth_substep"] = t
        log(f"time astaroth_substep 256^3 {dtype}: {t['ms']:.4f} ms per launch on the main "
            f"path's mix (plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by "
            f"{t['bound'][1]}, unfused issue {issue_ms(flops, dtype):.4f} ms)")
        del curr8, out8

    # -- 6. jacobi3d's remote-dma kernel variants ------------------------------
    # (label, spec, sel codes): the unaligned layouts' row pitch moves the
    # 16-byte phase every row (808 and 2,060 bytes), so their runs move 4
    # bytes at a time, and their last tiles are ragged
    fused_cases = [("512^3 r1", spec512, (0, 3)), (sweep_cases[1][0], sweep_cases[1][1], (0, 3)),
                   ("33x21x13 r2", sweep_cases[3][1], (0, 3))]
    fused_cases += [(f"{'x'.join(map(str, size))} r{r}{' unaligned' if not al else ''} sel in "
                     "[-1, 4)", GridSpec(Dim3(*size), Dim3(1, 1, 1), Radius.constant(r),
                                         aligned=al), (-1, 4))
                    for size, r, al in (((200, 100, 61), 1, False), ((513, 37, 19), 1, False),
                                        ((70, 45, 29), 3, True), ((70, 45, 29), 3, False))]
    for i, (label, spec, codes) in enumerate(fused_cases):
        plan = build_plan(spec, (1, 1, 1), Method.REMOTE_DMA, fused=True)
        c, n = rand_block(spec, 100 + i), rand_block(spec, 110 + i)
        s = rand_sel(spec, 120 + i, *codes)
        pc, pn = c.clone(), n.clone()
        fst.fused_jacobi(c, n, s, spec, plan)
        fst.fused_jacobi_plain(pc, pn, s, spec, plan)
        torch.cuda.synchronize()
        errs["fused_jacobi"] = max(errs["fused_jacobi"], max_abs(c, pc), max_abs(n, pn))
        check(torch.equal(c, pc) and torch.equal(n, pn), f"fused {label}: kernel != plain")
        log(f"fused_jacobi {label}: equal (curr with halos, out)")
    del c, n, s, pc, pn

    # (label, size, k, sel codes); k=8 runs two on-chip passes, 33x21x13
    # ragged tiles and z chunks
    pers_cases = [(f"200x100x60 k={k}", (200, 100, 60), k, (0, 3)) for k in (2, 3, 4, 6)]
    pers_cases += [("200x100x60 k=4 sel in [-1, 4)", (200, 100, 60), 4, (-1, 4)),
                   ("200x100x60 k=8 sel in [-1, 4)", (200, 100, 60), 8, (-1, 4)),
                   ("33x21x13 k=3 sel in [-1, 4)", (33, 21, 13), 3, (-1, 4)),
                   ("16x16x14 k=2", (16, 16, 14), 2, (0, 3)),
                   ("16x16x13 k=4", (16, 16, 13), 4, (0, 3)),
                   ("512^3 k=4", (512, 512, 512), 4, (0, 3))]
    for i, (label, size, k, codes) in enumerate(pers_cases):
        spec = GridSpec(Dim3(*size), Dim3(1, 1, 1), Radius.constant(k))
        c, n = rand_block(spec, 130 + i), rand_block(spec, 140 + i)
        s = rand_sel(spec, 150 + i, *codes)
        pc, pn, ps = c.clone(), n.clone(), s.clone()
        pst.persistent_jacobi(c, n, s, spec, k)
        pst.persistent_jacobi_plain(pc, pn, ps, spec, k)
        torch.cuda.synchronize()
        errs["persistent_jacobi"] = max(errs["persistent_jacobi"], max_abs(c, pc),
                                        max_abs(n, pn))
        check(torch.equal(c, pc) and torch.equal(n, pn) and torch.equal(s, ps),
              f"persistent {label}: kernel != plain")
        log(f"persistent_jacobi {label}: equal (both buffers, halos included)")
    del c, n, s, pc, pn, ps

    counted = {"fused_jacobi": fst.fused_jacobi, "persistent_jacobi": pst.persistent_jacobi,
               "jacobi_sweep": sk.sweep, "jacobi_multistep": sk.multistep,
               "self_fill": halo_fill.self_fill}
    variant_runs = [
        ("fused", dict(iters=50, chunk=25, kernel_variant="fused"),
         {"fused_jacobi": 75}),
        ("persistent", dict(iters=48, chunk=24, kernel_variant="persistent", deep_halo=4),
         {"persistent_jacobi": 18, "self_fill": 9}),
        ("plain remote-dma", dict(iters=10, chunk=5), {"jacobi_sweep": 15, "self_fill": 45}),
    ]
    for label, kw, want in variant_runs:
        for fn in counted.values():
            fn.launches = 0
        rv = jacobi3d.run(512, 512, 512, weak=False, method=Method.REMOTE_DMA, **kw)
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counted.items()}
        check(got == {name: want.get(name, 0) for name in counted},
              f"jacobi3d {label}: launches {got}, expected {want}")
        if label == "persistent":
            lpc = rv["domain"].halo_exchange.last_launches_per_chunk
            check(lpc == 1, f"jacobi3d persistent: {lpc} launches per chunk, not 1")
        if label != "plain remote-dma":
            launches[f"{label}_jacobi"] = got[f"{label}_jacobi"]
        check_field(rv, f"jacobi3d 512^3 {label}")
        log(jacobi3d.csv_row(rv))
        log(f"jacobi3d 512^3 remote-dma {label}: {rv['iter_trimean_s'] * 1e3:.4f} ms/iter "
            f"(trimean), {rv['mcells_per_s_per_dev']:.1f} Mcells/s, launches {got}")
        del rv

    # 8 steps from a random field: the default path (2 multistep passes + 2
    # sweeps), the fused loop and the persistent loop (k=4, radius-4 layout)
    spec4 = GridSpec(Dim3(512, 512, 512), Dim3(1, 1, 1), Radius.constant(4))
    off1, off4 = spec512.compute_offset(), spec4.compute_offset()

    def region(t, off):
        return t[..., off.z:off.z + 512, off.y:off.y + 512, off.x:off.x + 512]

    start, sel = rand_block(spec512, 7), sel_block(spec512)
    ref, _ = make_jacobi_loop(HaloExchange(spec512), 8)(start.clone(), torch.zeros_like(start),
                                                        sel)
    exf = HaloExchange(spec512, Method.REMOTE_DMA, fused=True)
    fused8, _ = make_jacobi_loop(exf, 8)(start.clone(), torch.zeros_like(start), sel)
    start4 = torch.zeros(spec4.stacked_shape_zyx(), device=dev)
    region(start4, off4).copy_(region(start, off1))
    exp = HaloExchange(spec4, Method.REMOTE_DMA, persistent=True)
    pers8, _ = make_jacobi_loop(exp, 8, temporal_k=4)(start4, torch.zeros_like(start4),
                                                      sel_block(spec4))
    torch.cuda.synchronize()
    check(torch.equal(region(fused8, off1), region(ref, off1)),
          "fused 8 steps at 512^3 != the default multistep path")
    check(torch.equal(region(pers8, off4), region(ref, off1)),
          "persistent 8 steps at 512^3 != the default multistep path")
    log("jacobi 512^3 8 steps: fused path == persistent (k=4) path == default path")
    del start, ref, fused8, start4, pers8

    # per-launch times at 512^3: the fused step (a cooperative launch the
    # graph captures) by CUDA-graph replay, the persistent chunk without a
    # CUDA graph (events around back-to-back launches)
    plan = build_plan(spec512, (1, 1, 1), Method.REMOTE_DMA, fused=True)
    c, n = rand_block(spec512, 8), rand_block(spec512, 9)
    timings["fused_jacobi"] = dict(
        ms=time_ms(lambda: fst.fused_jacobi(c, n, sel, spec512, plan), 20, graph=True),
        plain_ms=time_ms(lambda: fst.fused_jacobi_plain(c, n, sel, spec512, plan), 3, warmup=1),
        bound=bound_ms(12 * cells, 6 * cells), library_ms=None)
    del c, n, sel
    c, n, s = rand_block(spec4, 10), rand_block(spec4, 11), sel_block(spec4)
    grown = sum((512 + 2 * g) ** 3 for g in range(4))
    timings["persistent_jacobi"] = dict(
        ms=time_ms(lambda: pst.persistent_jacobi(c, n, s, spec4, 4), 10),
        plain_ms=time_ms(lambda: pst.persistent_jacobi_plain(c, n, s, spec4, 4), 1, warmup=1),
        bound=bound_ms(pst.chunk_bytes(spec4, 4), 6 * grown), library_ms=None)
    del c, n, s
    design = bound_ms(pst.chunk_design_bytes(spec4, 4), 6 * grown)[0]
    for name in ("fused_jacobi", "persistent_jacobi"):
        t = timings[name]
        log(f"time {name}: {t['ms']:.4f} ms per launch (plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound'][0]:.4f} ms by {t['bound'][1]})")
    log(f"persistent_jacobi 512^3 k=4: {timings['persistent_jacobi']['ms'] / 4:.4f} ms per "
        f"step; the design's own traffic ({pst.chunk_design_bytes(spec4, 4)} bytes per chunk) "
        f"bounds it at {design:.4f} ms")

    # -- 7. resident: multi-block partitions, every block on the card ---------
    from stencil_tpu_torch.ops.jacobi import multi_block_layout

    for key in ("jacobi_multistep_deep_halo", "jacobi_sweep_regions", "self_fill_z_stack"):
        errs[key] = 0.0

    def rspec(size, part, r, aligned=True):
        return GridSpec(Dim3(*size), Dim3(*part), Radius.constant(r), aligned=aligned)

    def rand_stack(spec, seed, dtype=torch.float32):
        gen.manual_seed(seed)
        return torch.rand(spec.stacked_shape_zyx(), generator=gen, device=dev).to(dtype)

    def blocks_of(spec):
        d, b = spec.dim, spec.base
        off = spec.compute_offset()
        for iz in range(d.z):
            for iy in range(d.y):
                for ix in range(d.x):
                    yield ((iz, iy, ix, slice(off.z, off.z + b.z), slice(off.y, off.y + b.y),
                            slice(off.x, off.x + b.x)),
                           (slice(iz * b.z, (iz + 1) * b.z), slice(iy * b.y, (iy + 1) * b.y),
                            slice(ix * b.x, (ix + 1) * b.x)))

    def place(g, spec):
        """A global [z, y, x] tensor scattered into the stacked layout."""
        t = torch.zeros(spec.stacked_shape_zyx(), dtype=g.dtype, device=dev)
        for local, glob in blocks_of(spec):
            t[local] = g[glob]
        return t

    def gather(t, spec):
        g = torch.empty(tuple(spec.global_size)[::-1], dtype=t.dtype, device=dev)
        for local, glob in blocks_of(spec):
            g[glob] = t[local]
        return g

    # the deep-halo multistep against its plain version, noise in every halo
    spec_h = rspec((512,) * 3, (2, 2, 2), 4)  # the headline's layout
    kh = sk.MULTISTEP_KPLAN
    # every depth its radius-4 halos allow
    deep_cases = [(f"512^3 (2,2,2) r4 k={k}", spec_h, k)
                  for k in range(2, min(sk.MULTISTEP_KMAX, spec_h.radius.x(1)) + 1)]
    deep_cases += [("100x70x60 (2,2,2) r2 unaligned k=2", rspec((100, 70, 60), (2, 2, 2), 2, False), 2),
                   ("200x100x60 (1,1,2) r3 k=3 mixed wrap", rspec((200, 100, 60), (1, 1, 2), 3), 3),
                   ("128x16x20 (1,1,2) r2 k=2 spheres across z", rspec((128, 16, 20), (1, 1, 2), 2), 2)]
    for i, (label, spec, k) in enumerate(deep_cases):
        c = rand_stack(spec, 200 + i)
        got = sk.multistep(c, torch.zeros_like(c), spec, k)
        want = sk.multistep_plain(c, torch.zeros_like(c), spec, k)
        torch.cuda.synchronize()
        errs["jacobi_multistep_deep_halo"] = max(errs["jacobi_multistep_deep_halo"],
                                                 max_abs(got, want))
        check(torch.equal(got, want), f"deep-halo multistep {label}: kernel != plain")
        log(f"deep-halo multistep {label}: equal (zchunks "
            f"{sk.multistep_zchunks(spec, k, sk.multistep_blocks_in_flight(dev, k))})")
    del c, got, want

    # the stacked sweep and every shell of every block in one launch
    # (sweep_regions; sweep_region on one shell), random sel codes on every
    # plane and the spheres on each block's own planes
    spec_m = rspec((200, 100, 60), (1, 1, 2), 3)
    for spec in (spec_h, spec_m):
        wrap, _axes, shells = multi_block_layout(spec)
        c = rand_stack(spec, 210)
        gen.manual_seed(211)
        rs7 = torch.randint(-1, 4, spec.stacked_shape_zyx(), generator=gen, device=dev,
                            dtype=torch.int32)
        for what, s7, rg in (("random sel", rs7, None),
                             ("spheres on their planes", sphere_sel_blocks(spec, dev),
                              sk.block_sel_ranges(spec))):
            got = sk.sweep(c, torch.zeros_like(c), s7, spec, wrap, rg)
            want = sk.sweep_plain(c, torch.zeros_like(c), s7, spec, wrap, rg)
            sk.sweep_regions([c], [got], [s7], spec, [shells], [rg])
            for rect in shells:
                sk.region_plain(c, want, s7, spec, rect, rg)
            one = sk.sweep_region(c, torch.zeros_like(c), s7, spec, shells[0], rg)
            one_want = sk.region_plain(c, torch.zeros_like(c), s7, spec, shells[0], rg)
            torch.cuda.synchronize()
            errs["jacobi_sweep"] = max(errs["jacobi_sweep"], max_abs(got, want))
            errs["jacobi_sweep_regions"] = max(errs["jacobi_sweep_regions"], max_abs(got, want),
                                              max_abs(one, one_want))
            check(torch.equal(got, want) and torch.equal(one, one_want),
                  f"stacked sweep + shells {spec.dim}, {what}: kernel != plain")
        log(f"stacked sweep (wrap {wrap}) + {len(shells)} shells of {spec.num_blocks()} blocks "
            f"in one launch, {spec.global_size} over {spec.dim}: equal with random sel and the "
            "spheres on their planes")
    del c, rs7, s7, got, want, one, one_want

    # the z-stack fill over a (1,1,2) stack, x and y, fp32 and fp64
    spec_z = rspec((512,) * 3, (1, 1, 2), 3)
    for dtype in (torch.float32, torch.float64):
        qs = [rand_stack(spec_z, 220 + q, dtype) for q in range(4)]
        for axis in ("x", "y"):
            got = halo_fill.self_fill([q.clone() for q in qs], spec_z, axis, z_stack=2)
            want = halo_fill.self_fill_plain([q.clone() for q in qs], spec_z, axis)
            torch.cuda.synchronize()
            for g_, w_ in zip(got, want):
                errs["self_fill_z_stack"] = max(errs["self_fill_z_stack"], max_abs(g_, w_))
                check(torch.equal(g_, w_), f"z-stack fill {dtype} {axis}: kernel != plain")
        log(f"z-stack fill 512^3 (1,1,2) r3 x4 {dtype} x/y: equal")
        del qs, got, want

    # the resident exchange on the card against the same exchange on the CPU;
    # every self-wrap axis is filled by the fill kernel (one launch per dtype
    # group and x/y axis; z beside x residents: one per 16 resident blocks)
    f32, f64 = torch.float32, torch.float64
    mixed = [f32, f32, f32, f64]
    for label, spec, dts, nfill in (
            ("config 2: 256^3 (2,2,2) r2 x4", rspec((256,) * 3, (2, 2, 2), 2), [f32] * 4, 0),
            ("256^3 (1,1,2) r3 3 fp32 + 1 fp64", rspec((256,) * 3, (1, 1, 2), 3), mixed, 4),
            ("256^3 (2,1,1) r3 3 fp32 + 1 fp64", rspec((256,) * 3, (2, 1, 1), 3), mixed, 4)):
        ex7 = HaloExchange(spec)
        st = {i: rand_stack(spec, 230 + i, dt) for i, dt in enumerate(dts)}
        on_cpu = {i: t.cpu() for i, t in st.items()}
        halo_fill.self_fill.launches = 0
        ex7(st)
        torch.cuda.synchronize()
        check(halo_fill.self_fill.launches == nfill,
              f"exchange {label}: {halo_fill.self_fill.launches} fill launches, not {nfill}")
        ex7(on_cpu)
        for i in st:
            check(torch.equal(st[i].cpu(), on_cpu[i]), f"exchange {label} q{i}: card != CPU")
        log(f"resident exchange {label}: card == CPU on every cell, {nfill} fill launches")
    del st, on_cpu, ex7

    # 8 steps from a random field: residents against the single-block path
    gen.manual_seed(240)
    g8 = torch.rand((512, 512, 512), generator=gen, device=dev)
    sel_g = sel_block(spec512)[(0, 0, 0, *[slice(o, o + 512) for o in
                                           (off1.z, off1.y, off1.x)])].contiguous()
    ref8, _ = make_jacobi_loop(HaloExchange(spec512), 8)(
        place(g8, spec512), torch.zeros(spec512.stacked_shape_zyx(), device=dev),
        place(sel_g, spec512))
    ref8 = gather(ref8, spec512)
    for label, spec, overlap, kw in (("(2,2,2) r3 overlap", rspec((512,) * 3, (2, 2, 2), 3), True, 3),
                                     ("(1,1,2) r3 overlap", rspec((512,) * 3, (1, 1, 2), 3), True, 3),
                                     ("(2,2,2) r1 no overlap", rspec((512,) * 3, (2, 2, 2), 1), False,
                                      0)):
        loop = make_jacobi_loop(HaloExchange(spec), 8, overlap=overlap)
        check(loop.temporal_k == kw, f"resident 8 steps {label}: k={loop.temporal_k}, not {kw}")
        out, _ = loop(place(g8, spec), torch.zeros(spec.stacked_shape_zyx(), device=dev),
                      place(sel_g, spec))
        torch.cuda.synchronize()
        check(torch.equal(gather(out, spec), ref8), f"resident 8 steps {label} != single block")
        log(f"jacobi 512^3 8 steps {label} (k={kw}): == the single-block default path")
        del out, loop
    del g8, ref8

    # the main paths: jacobi3d 512^3 over (2,2,2), deep halo 4 and 1
    # (every shell of every block of a step in one sweep_regions launch)
    counted7 = {"jacobi_multistep": sk.multistep, "jacobi_sweep": sk.sweep,
                "jacobi_sweep_regions": sk.sweep_regions, "self_fill": halo_fill.self_fill}
    hot_d, cold_d = sk.sphere_masks_from_coords(spec512, dev)
    for label, kw, k_want, want in (
            ("deep_halo 4", dict(iters=50, chunk=25, deep_halo=4), kh,
             {"jacobi_multistep": 3 * (25 // kh), "jacobi_sweep": 3 * (25 % kh),
              "jacobi_sweep_regions": 3 * (25 % kh)}),
            ("deep_halo 1", dict(iters=50, chunk=25, deep_halo=1), 0,
             {"jacobi_sweep": 75, "jacobi_sweep_regions": 75})):
        for fn in counted7.values():
            fn.launches = 0
        rv = jacobi3d.run(512, 512, 512, weak=False, partition=(2, 2, 2), **kw)
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counted7.items()}
        check(got == {name: want.get(name, 0) for name in counted7},
              f"jacobi3d (2,2,2) {label}: launches {got}, expected {want}")
        check(rv["temporal_k"] == k_want, f"jacobi3d (2,2,2) {label}: k={rv['temporal_k']}")
        fin = gather(rv["domain"].get_curr(rv["handle"]), rv["domain"].spec)
        check(bool(torch.isfinite(fin).all()) and float(fin.min()) >= 0.0
              and float(fin.max()) <= 1.0 and bool((fin[hot_d] == 1.0).all())
              and bool((fin[cold_d] == 0.0).all()),
              f"jacobi3d (2,2,2) {label}: field not finite, out of range or spheres lost")
        if label == "deep_halo 4":
            launches["jacobi_multistep_deep_halo"] = got["jacobi_multistep"]
            launches["jacobi_sweep_regions"] = got["jacobi_sweep_regions"]
        log(jacobi3d.csv_row(rv))
        log(f"jacobi3d 512^3 (2,2,2) resident {label}: {rv['iter_trimean_s'] * 1e3:.4f} ms/iter "
            f"(trimean), {rv['mcells_per_s_per_dev']:.1f} Mcells/s, temporal_k "
            f"{rv['temporal_k']}, launches {got}")
        del rv, fin

    # the resident exchanges in GB/s; the last is the exchange of each
    # deep-halo pass of the deep_halo=4 run (its curr, all three axes)
    resident_gbs = {}
    for label, n7, part, r7, nq7, zfills in (
            ("config 2: 256^3 (2,2,2) r2 x4", 256, (2, 2, 2), 2, 4, 0),
            ("512^3 (1,1,2) r3 x4", 512, (1, 1, 2), 3, 4, 2),
            ("512^3 (2,2,2) r4 x1 (deep_halo 4's)", 512, (2, 2, 2), 4, 1, 0)):
        dd = DistributedDomain(n7, n7, n7)
        dd.set_radius(r7)
        dd.set_partition(part)
        hs = [dd.add_data(f"q{i}", "float32") for i in range(nq7)]
        dd.realize()
        for i, hq in enumerate(hs):
            dd.set_curr(hq, rand_stack(dd.spec, 250 + i))
        halo_fill.self_fill.launches = 0
        dd.exchange_loop(1)(dd.curr_state())
        torch.cuda.synchronize()
        check(halo_fill.self_fill.launches == zfills,
              f"exchange {label}: {halo_fill.self_fill.launches} fill launches, not {zfills}")
        if part == (1, 1, 2):
            launches["self_fill_z_stack"] = halo_fill.self_fill.launches
        loop10 = dd.exchange_loop(10)
        ex_ms = time_ms(lambda: loop10(dd.curr_state()), 3, warmup=1) / 10
        nbytes = dd.exchange_bytes_for_method(dd.halo_exchange.method)
        log(f"resident exchange {label}: {ex_ms:.4f} ms, {nbytes / ex_ms / 1e6:.2f} GB/s logical "
            f"({nbytes} bytes; {dd.exchange_bytes_moved()} moved), fill launches {zfills}")
        resident_gbs[label] = nbytes / ex_ms / 1e6
        del dd, loop10

    # per-launch times of the new forms at the main paths' shapes
    c, n7 = rand_stack(spec_h, 260), torch.zeros(spec_h.stacked_shape_zyx(), device=dev)
    grown = spec_h.num_blocks() * (256 + 2 * kh) ** 3
    timings["jacobi_multistep_deep_halo"] = dict(
        ms=time_ms(lambda: sk.multistep(c, n7, spec_h, kh), 5, warmup=1, graph=True),
        plain_ms=time_ms(lambda: sk.multistep_plain(c, n7, spec_h, kh), 1, warmup=1),
        bound=bound_ms(4 * (grown + cells), 6 * kh * cells), library_ms=None)
    _wrap, _axes, shells_h = multi_block_layout(spec_h)
    s7 = place(sel_g, spec_h)
    rg_h = sk.block_sel_ranges(spec_h)
    # a step's shells: all six of every block in one launch
    timings["jacobi_sweep_regions"] = b1_form(
        lambda: sk.sweep_regions([c], [n7], [s7], spec_h, [shells_h], [rg_h]),
        lambda: [sk.region_plain(c, n7, s7, spec_h, rc, rg_h) for rc in shells_h],
        spec_h, shells_h, rg_h, reps=10, plain_reps=1)
    b1_log("jacobi_sweep_regions", timings["jacobi_sweep_regions"],
           f"512^3 (2,2,2) r4, the {len(shells_h)} shells of 8 blocks in one launch")
    # what jacobi_sweep_region measured until the shells became one launch:
    # sweep_region's launch of one shell of the 8 blocks, the mean over the 6
    one_shell = time_ms(lambda: [sk.sweep_region(c, n7, s7, spec_h, rc, rg_h) for rc in shells_h],
                        10, graph=True) / len(shells_h)
    timings["jacobi_sweep_regions"]["extra"]["one_shell_ms"] = one_shell
    log(f"time sweep_region one r4 shell of 8 blocks a launch: {one_shell:.4f} ms (mean of "
        f"{len(shells_h)})")
    # the stacked sweep of the same blocks, wrap off on every axis
    wrap_h, _axes, _shells = multi_block_layout(spec_h)
    t7 = b1_form(lambda: sk.sweep(c, n7, s7, spec_h, wrap_h, rg_h),
                 lambda: sk.sweep_plain(c, n7, s7, spec_h, wrap_h, rg_h), spec_h,
                 [Rect3(spec_h.compute_offset(), spec_h.compute_offset() + spec_h.base)], rg_h,
                 plain_reps=1)
    b1_log("jacobi_sweep", t7, "512^3 (2,2,2) r4 stacked, each block's sel on its planes")
    timings["jacobi_sweep"]["extra"]["stacked_ms"] = t7["ms"]
    del c, n7, s7, t7
    qs = [rand_stack(spec_z, 270 + q) for q in range(4)]

    def zfill_plain():
        for axis in ("x", "y"):
            halo_fill.self_fill_plain(qs, spec_z, axis)

    # the kernel's times are phase 2's (apps/bench_fill.py, the z-stack case)
    mean, extra = per_axis(bench_fill.CASES[1][0])
    timings["self_fill_z_stack"] = dict(
        ms=mean("ms"), plain_ms=time_ms(zfill_plain, 5) / 2, bound=(mean("bound_ms"), "bytes"),
        library_ms=mean("copy_ms"), extra=extra)
    del qs
    for name in ("jacobi_multistep_deep_halo", "self_fill_z_stack"):
        t = timings[name]
        log(f"time {name}: {t['ms']:.4f} ms per launch (plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound'][0]:.4f} ms by {t['bound'][1]}"
            + (f", Tensor.copy_ {t['library_ms']:.4f} ms" if t["library_ms"] else "") + ")")
    log(f"jacobi_multistep_deep_halo 512^3 (2,2,2) k={kh}: "
        f"{timings['jacobi_multistep_deep_halo']['ms'] / kh:.4f} ms per step")

    # -- 8. campaign: the tenant-form sweep and the multi-tenant driver --------
    from stencil_tpu_torch.apps import campaign as campaign_app
    from stencil_tpu_torch.campaign import SlotHealthGuard
    from stencil_tpu_torch.obs import FAULT_RC, telemetry
    from stencil_tpu_torch.ops.jacobi import make_batched_jacobi_loop

    errs["jacobi_sweep_batched"] = 0.0

    def tenant_spec(size, r=1):
        return GridSpec(Dim3(*size), Dim3(1, 1, 1), Radius.constant(r), aligned=False)

    def rand_slot(spec, b, seed):
        gen.manual_seed(seed)
        p = spec.padded()
        return (torch.rand((b, p.z, p.y, p.x), generator=gen, device=dev),
                torch.randint(0, 3, (b, p.z, p.y, p.x), generator=gen, device=dev,
                              dtype=torch.int32))

    def compute_of(spec):
        off, b = spec.compute_offset(), spec.base
        return (slice(None), slice(off.z, off.z + b.z), slice(off.y, off.y + b.y),
                slice(off.x, off.x + b.x))

    for i, (label, size, r8, b8) in enumerate((
            ("B=64 of 32^3", (32, 32, 32), 1, 64), ("B=3 of 33x21x13 r1", (33, 21, 13), 1, 3),
            ("B=3 of 33x21x13 r2", (33, 21, 13), 2, 3), ("B=1 of 32^3", (32, 32, 32), 1, 1),
            ("B=70000 of 4^3", (4, 4, 4), 1, 70000))):
        spec = tenant_spec(size, r8)
        c, s8 = rand_slot(spec, b8, 300 + i)
        got = sk.sweep_tenants(c, torch.zeros_like(c), s8, spec)
        want = sk.sweep_plain(c, torch.zeros_like(c), s8, spec)
        torch.cuda.synchronize()
        errs["jacobi_sweep_batched"] = max(errs["jacobi_sweep_batched"], max_abs(got, want))
        check(torch.equal(got, want), f"tenant sweep {label}: kernel != plain")
        log(f"tenant sweep {label}: equal")
    # the campaign's own call: every tenant's spheres on their planes
    for i, size in enumerate((32, 128)):
        spec = tenant_spec((size,) * 3)
        p = spec.padded()
        c, _s = rand_slot(spec, 64, 320 + i)
        s8 = sphere_sel_blocks(spec, dev).view(1, p.z, p.y, p.x).expand(64, -1, -1, -1)
        s8 = s8.contiguous()
        got = sk.sweep_tenants(c, torch.zeros_like(c), s8, spec, sk.sel_z_range(spec))
        want = sk.sweep_plain(c, torch.zeros_like(c), s8, spec, sel_range=sk.sel_z_range(spec))
        torch.cuda.synchronize()
        errs["jacobi_sweep_batched"] = max(errs["jacobi_sweep_batched"], max_abs(got, want))
        check(torch.equal(got, want), f"tenant sweep B=64 of {size}^3, spheres on their "
                                      "planes: kernel != plain")
        log(f"tenant sweep B=64 of {size}^3 (pitch {p.x}), spheres on their planes: equal")
    del c, s8, got, want
    # a float64 slot on the card against the same slot on the CPU
    spec = tenant_spec((8, 8, 8))
    c, s8 = rand_slot(spec, 2, 310)
    c = c.double()
    got = sk.sweep_tenants(c, torch.zeros_like(c), s8, spec)
    want = sk.sweep_tenants(c.cpu(), torch.zeros_like(c.cpu()), s8.cpu(), spec)
    check(got.dtype == torch.float64 and torch.equal(got.cpu(), want),
          "tenant sweep B=2 of 8^3 fp64: card != CPU")
    log("tenant sweep B=2 of 8^3 fp64: card == CPU")

    # the batched loop on the card against the same loop on the CPU. The
    # card reads sel on the spheres' planes only (sel_z_range, as the TPU
    # kernel), the CPU on every plane (the JAX package's XLA branch): random
    # codes on those planes and the spheres agree as they are; random codes
    # on every plane agree with the CPU's loop given them zeroed elsewhere
    spec = tenant_spec((24, 24, 24))
    c, s8 = rand_slot(spec, 8, 320)
    p24 = spec.padded()
    sph24 = sphere_sel_blocks(spec, dev).view(1, p24.z, p24.y, p24.x).expand(8, -1, -1, -1)
    lo24, hi24 = sk.sel_z_range(spec)
    planes24 = torch.zeros_like(s8)
    planes24[:, lo24:hi24] = s8[:, lo24:hi24]
    cs = compute_of(spec)
    for what, card_sel, cpu_sel in (
            ("random sel on the spheres' planes", planes24, planes24),
            ("the spheres", sph24.contiguous(), sph24),
            ("random sel on every plane", s8, planes24)):
        gc, gn = make_batched_jacobi_loop(spec, 3, device=dev)(
            c.clone(), torch.zeros_like(c), card_sel)
        cc, cn = make_batched_jacobi_loop(spec, 3, device="cpu")(
            c.cpu(), torch.zeros_like(c.cpu()), cpu_sel.cpu())
        check(torch.equal(gc[cs].cpu(), cc[cs]) and torch.equal(gn[cs].cpu(), cn[cs]),
              f"batched loop B=8 of 24^3, 3 steps, {what}: card != CPU")
    log("make_batched_jacobi_loop B=8 of 24^3 3 steps: card == CPU on the compute regions "
        "(random sel and the spheres; sel off the spheres' planes ignored on the card)")
    del c, s8, planes24, gc, gn, cc, cn

    counted8 = {"jacobi_sweep_batched": sk.sweep_tenants, "jacobi_sweep": sk.sweep,
                "jacobi_multistep": sk.multistep}

    def run_campaign(argv):
        """apps.campaign.run_modes on ``argv`` in a temporary directory, with
        its telemetry records and the launch counts of its run."""
        with tempfile.TemporaryDirectory(prefix="chip-smoke-campaign-") as d:
            metrics = os.path.join(d, "metrics.jsonl")
            telemetry.configure(metrics_out=metrics, app="chip_smoke")
            for fn in counted8.values():
                fn.launches = 0
            out = campaign_app.run_modes(campaign_app.parse_args(argv),
                                         os.path.join(d, "campaign"))
            torch.cuda.synchronize()
            got8 = {name: fn.launches for name, fn in counted8.items()}
            telemetry.get().close()
            recs = [json.loads(line) for line in open(metrics) if line.strip()]
        return out, got8, recs

    def campaign_ab(edge, tenants):
        """The CLI's A/B at ``tenants`` tenants of ``edge``^3 in one slot
        (launch counts, parity), then a 30-step batched run whose slot
        chunks (10 of 3 steps) give the steady-state host share: one chunk's
        device work (3 tenant sweeps and the per-lane health reductions,
        each timed as a CUDA-graph replay on a slot of the same shape)
        against the chunk's wall (the step with its synchronize, then the
        health check)."""
        shape = ["--tenants", str(tenants), "--slot", str(tenants), "--size", str(edge),
                 "--chunk", "3"]
        out, got8, _ = run_campaign(shape + ["--steps", "6", "--mode", "ab", "--check-parity"])
        want8 = {"jacobi_sweep_batched": 6, "jacobi_sweep": 0, "jacobi_multistep": 2 * tenants}
        check(got8 == want8, f"campaign A/B {tenants} x {edge}^3: launches {got8}, expected {want8}")
        check(out["parity"] == "ok" and out["evicted"] == [],
              f"campaign A/B {tenants} x {edge}^3: parity {out['parity']}, evicted {out['evicted']}")
        # the kernels are built (or loaded) before either mode is timed: no
        # step holds a build of seconds
        check(out["build_s"] >= 0.0 and out["sequential_p99_step_s"] < 1.0
              and out["batched_p99_step_s"] < 1.0,
              f"campaign A/B {tenants} x {edge}^3: a step of a second or more (build_s "
              f"{out['build_s']}, p99 {out['sequential_p99_step_s']}, "
              f"{out['batched_p99_step_s']})")
        for res in out["_batched"]["results"].values():
            check(res.final.shape == (edge,) * 3 and bool(np.isfinite(res.final).all()),
                  f"campaign {edge}^3 tenant {res.tid}: not finite or wrong shape")
        log(f"campaign A/B {tenants} tenants of {edge}^3, 6 steps in chunks of 3: batched "
            f"{out['batched_mcells_per_s']} Mcells/s (p50 {out['batched_p50_step_s']} s, p99 "
            f"{out['batched_p99_step_s']} s per step), sequential "
            f"{out['sequential_mcells_per_s']} Mcells/s (p50 {out['sequential_p50_step_s']} s, p99 "
            f"{out['sequential_p99_step_s']} s), ratio {out['batched_over_sequential']}, parity "
            f"{out['parity']}, launches {got8}; kernel build {out['build_s']} s outside the "
            "timed spans")
        steady, _, recs = run_campaign(shape + ["--steps", "30"])
        spec8 = tenant_spec((edge,) * 3)
        c8, _s = rand_slot(spec8, tenants, 330)
        n8 = torch.zeros_like(c8)
        # the slot's own sweep: the spheres, read on their planes
        p8 = spec8.padded()
        s88 = sphere_sel_blocks(spec8, dev).view(1, p8.z, p8.y, p8.x).expand(tenants, -1, -1, -1)
        s88, rg88 = s88.contiguous(), sk.sel_z_range(spec8)
        sweep3_ms = 3 * time_ms(lambda: sk.sweep_tenants(c8, n8, s88, spec8, rg88), 20,
                                graph=True)
        reduce_ms = time_ms(lambda: SlotHealthGuard._reduce({"temperature": c8}), 20, graph=True)
        dev_ms = sweep3_ms + reduce_ms
        del c8, s88, n8, _s
        steps = [r["value"] * r["iters"] * 1e3 for r in recs
                 if r["name"] == "campaign.step_latency_s"]
        checks = [r["seconds"] * 1e3 for r in recs if r["name"] == "health.check"]
        step_ms, check_ms = float(np.median(steps)), float(np.median(checks))
        log(f"campaign slot chunk {tenants} x {edge}^3 (3 steps, median of {len(steps)} chunks, "
            f"first {steps[0]:.4f} ms + check {checks[0]:.4f} ms): device {dev_ms:.4f} ms "
            f"(3 sweeps {sweep3_ms:.4f} + health reductions {reduce_ms:.4f}), wall "
            f"{step_ms + check_ms:.4f} ms (step {step_ms:.4f} + health check {check_ms:.4f}): "
            f"host share {1 - dev_ms / (step_ms + check_ms):.3f}; 30 steps batched "
            f"{steady['batched_mcells_per_s']} Mcells/s")
        return got8

    launches["jacobi_sweep_batched"] = campaign_ab(32, 64)["jacobi_sweep_batched"]
    campaign_ab(128, 64)

    # the fault run: t1 poisoned at its step 3 every time it gets there
    fault_args = ["--tenants", "8", "--slot", "4", "--size", "32", "--steps", "6", "--chunk", "2"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fault-") as d:
        guarded = ["--ckpt-every", "2", "--max-rollbacks", "1", "--rollback-backoff", "0.01"]
        clean = campaign_app.run_modes(campaign_app.parse_args(fault_args + guarded),
                                       os.path.join(d, "clean"))["_batched"]
        inj_dir = os.path.join(d, "inj")
        inj = campaign_app.run_modes(campaign_app.parse_args(
            fault_args + guarded + ["--inject", "nan@3:tenant=t1:repeat=always"]),
            inj_dir)["_batched"]
        rev = campaign_app.run_modes(campaign_app.parse_args(fault_args + ["--resume"]),
                                     inj_dir)["_batched"]
        check(clean["evicted"] == [] and inj["evicted"] == ["t1"],
              f"fault run: evicted {inj['evicted']} (clean {clean['evicted']})")
        evidence = json.load(open(inj["results"]["t1"].evidence))
        check(evidence["rc"] == FAULT_RC == 43, f"fault run: evidence rc {evidence['rc']}")
        finals = {t: r.final.tobytes() for t, r in clean["results"].items()}
        survivors = {t: r for t, r in inj["results"].items() if t != "t1"}
        check(len(survivors) == 7 and all(r.outcome == "done" and r.final.tobytes() == finals[t]
                                          for t, r in survivors.items()),
              "fault run: a survivor differs from the clean run")
        r1 = rev["results"]["t1"]
        check(r1.outcome == "done" and r1.steps == 6 and r1.final.tobytes() == finals["t1"],
              "fault run: the revived t1 differs from the clean run")
    log("campaign fault run 8 x 32^3, slot 4: t1 evicted (rc 43 evidence), 7 survivors == clean "
        "run, --resume revives t1 == clean run")

    # the tenant sweep at B=64 of 128^3 (headline run 2's slot) against its
    # plain version, then per launch
    spec = tenant_spec((128, 128, 128))
    c, s8 = rand_slot(spec, 64, 340)
    got = sk.sweep_tenants(c, torch.zeros_like(c), s8, spec)
    want = sk.sweep_plain(c, torch.zeros_like(c), s8, spec)
    torch.cuda.synchronize()
    errs["jacobi_sweep_batched"] = max(errs["jacobi_sweep_batched"], max_abs(got, want))
    check(torch.equal(got, want), "tenant sweep B=64 of 128^3: kernel != plain")
    log("tenant sweep B=64 of 128^3: equal")
    del got, want
    n8 = torch.zeros_like(c)
    whole8 = [Rect3(spec.compute_offset(), spec.compute_offset() + spec.base)]
    # the campaign's call (the spheres on their planes), then random sel
    # codes read on every plane; and 64 of 32^3
    p8 = spec.padded()
    sph8 = sphere_sel_blocks(spec, dev).view(1, p8.z, p8.y, p8.x).expand(64, -1, -1, -1)
    sph8, rg8 = sph8.contiguous(), sk.sel_z_range(spec)
    timings["jacobi_sweep_batched"] = b1_form(
        lambda: sk.sweep_tenants(c, n8, sph8, spec, rg8),
        lambda: sk.sweep_plain(c, n8, sph8, spec, sel_range=rg8), spec, whole8, rg8, blocks=64)
    b1_log("jacobi_sweep_batched", timings["jacobi_sweep_batched"],
           "B=64 of 128^3, the spheres on their planes")
    t8 = b1_form(lambda: sk.sweep_tenants(c, n8, s8, spec),
                 lambda: sk.sweep_plain(c, n8, s8, spec), spec, whole8, blocks=64)
    b1_log("jacobi_sweep_batched", t8, "B=64 of 128^3, random sel on every plane")
    timings["jacobi_sweep_batched"]["extra"]["every_plane_ms"] = t8["ms"]
    spec32 = tenant_spec((32, 32, 32))
    c32, s32 = rand_slot(spec32, 64, 341)
    n32 = torch.zeros_like(c32)
    t8 = b1_form(lambda: sk.sweep_tenants(c32, n32, s32, spec32),
                 lambda: sk.sweep_plain(c32, n32, s32, spec32), spec32,
                 [Rect3(spec32.compute_offset(), spec32.compute_offset() + spec32.base)],
                 blocks=64)
    b1_log("jacobi_sweep_batched", t8, "B=64 of 32^3, random sel on every plane")
    timings["jacobi_sweep_batched"]["extra"]["b64_32_ms"] = t8["ms"]
    del c, s8, n8, sph8, c32, s32, n32, t8


    # -- 9. mesh: eight block positions on the card -----------------------------
    from stencil_tpu_torch.ops import remote_dma as rdma
    from stencil_tpu_torch.parallel import DeviceMesh, join_positions, split_positions

    for key in ("remote_axis", "fused_exchange"):
        errs[key] = 0.0

    def mesh_of(spec, device=dev):
        return DeviceMesh(spec.dim, [device] * spec.dim.flatten())

    def rand_mesh(spec, dtypes, seed):
        """{q: [block per position]}: random everywhere, halos and pad too."""
        p = spec.padded()
        out = {}
        for q, dt in enumerate(dtypes):
            gen.manual_seed(seed + q)
            out[q] = [torch.rand((1, 1, 1, p.z, p.y, p.x), generator=gen, device=dev).to(dt)
                      for _ in range(spec.num_blocks())]
        return out

    def grouped(state, keys):
        npos = len(state[keys[0]])
        return [[state[k][i] for k in keys] for i in range(npos)]

    def cloned(groups):
        return [[b.clone() for b in g] for g in groups]

    def same(a, b):
        return all(torch.equal(x, y) for ga, gb in zip(a, b) for x, y in zip(ga, gb))

    def err_of(a, b):
        return max(max_abs(x, y) for ga, gb in zip(a, b) for x, y in zip(ga, gb))

    mesh8 = DeviceMesh((2, 2, 2), [dev] * 8)

    def asym_spec(size, part, faces, aligned=True):
        """Face radii (x-, x+, y-, y+, z-, z+), every edge and corner on."""
        r = Radius()
        for d, v in zip(((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)),
                        faces):
            r.set_dir(d, v)
        r.set_edge(1)
        r.set_corner(1)
        return GridSpec(Dim3(*size), Dim3(*part), r, aligned=aligned)

    # each kernel against its plain version, every cell of every position;
    # the last three reach the row-move body's one-word layout off the
    # 16-byte grid (odd pitches), a lone x message (rm == 0 on x, and on y
    # in the fp64 group) and fp64 16-byte units
    mesh_cases = [
        ("config 2: 256^3 (2,2,2) r2 x4 fp32", rspec((256,) * 3, (2, 2, 2), 2), [f32] * 4),
        ("512^3 (2,2,2) r1 x1", rspec((512,) * 3, (2, 2, 2), 1), [f32]),
        ("100x70x60 (1,1,2) r1", rspec((100, 70, 60), (1, 1, 2), 1), [f32]),
        ("66x20x16 (2,1,1) r2 2 fp64", rspec((66, 20, 16), (2, 1, 1), 2), [f64, f64]),
        ("64^3 (2,2,2) r1 fp32 + fp64 + fp32", rspec((64,) * 3, (2, 2, 2), 1), [f32, f64, f32]),
        ("100x70x60 (2,2,2) r1 unaligned", rspec((100, 70, 60), (2, 2, 2), 1, aligned=False),
         [f32]),
        ("96x64x48 (2,2,2) radii x 0/2 y 1/2 z 2/1 fp32 + fp64",
         asym_spec((96, 64, 48), (2, 2, 2), (0, 2, 1, 2, 2, 1)), [f32, f64]),
        ("70x34x26 (2,2,1) radii x 1/3 y 0/1 z 1/2 unaligned fp64",
         asym_spec((70, 34, 26), (2, 2, 1), (1, 3, 0, 1, 1, 2), aligned=False), [f64]),
        ("128^3 (2,2,2) r2 x2 fp64", rspec((128,) * 3, (2, 2, 2), 2), [f64, f64]),
    ]
    for i, (label, spec, dts) in enumerate(mesh_cases):
        mesh = mesh_of(spec)
        st = rand_mesh(spec, dts, 400 + 10 * i)
        plan = build_plan(spec, spec.dim, Method.REMOTE_DMA)
        fplan = build_plan(spec, spec.dim, Method.REMOTE_DMA, fused=True)
        for dt in dict.fromkeys(dts):
            start = grouped(st, [k for k, d in enumerate(dts) if d == dt])
            for ph in plan.remote_phases:
                if ph.ring < 2 or not ph.active:
                    continue
                got = rdma.remote_axis(cloned(start), spec, ph, mesh)
                want = rdma.remote_axis_plain(cloned(start), spec, ph, mesh)
                torch.cuda.synchronize()
                errs["remote_axis"] = max(errs["remote_axis"], err_of(got, want))
                check(same(got, want), f"remote_axis {label} {dt} {ph.axis}: kernel != plain")
            got = fst.fused_exchange(cloned(start), spec, fplan, mesh)
            want = fst.fused_exchange_plain(cloned(start), spec, fplan, mesh)
            torch.cuda.synchronize()
            errs["fused_exchange"] = max(errs["fused_exchange"], err_of(got, want))
            check(same(got, want), f"fused_exchange {label} {dt}: kernel != plain")
        # the whole mesh exchange (ring phases, self-wrap fills) on the card
        # against the same exchange on the CPU
        cpu_mesh = mesh_of(spec, torch.device("cpu"))
        for fused in (False, True):
            on_card = {q: [b.clone() for b in bl] for q, bl in st.items()}
            on_cpu = {q: [b.cpu() for b in bl] for q, bl in st.items()}
            HaloExchange(spec, Method.REMOTE_DMA, mesh=mesh, fused=fused)(on_card)
            HaloExchange(spec, Method.REMOTE_DMA, mesh=cpu_mesh, fused=fused)(on_cpu)
            for q in st:
                check(all(torch.equal(a.cpu(), b) for a, b in zip(on_card[q], on_cpu[q])),
                      f"mesh exchange {label} fused={fused} q{q}: card != CPU")
            del on_card, on_cpu
        log(f"mesh {label}: remote_axis and fused_exchange == plain on every cell; "
            "both exchanges on the card == the CPU")
        del st

    # the mesh exchange against the resident AXIS_COMPOSED exchange
    for label, spec, nq in (("config 2", rspec((256,) * 3, (2, 2, 2), 2), 4),
                            ("512^3 (2,2,2) r1", rspec((512,) * 3, (2, 2, 2), 1), 1)):
        stacked = {q: rand_stack(spec, 420 + q) for q in range(nq)}
        on_mesh = {q: split_positions(t, spec, mesh8) for q, t in stacked.items()}
        HaloExchange(spec, Method.REMOTE_DMA, mesh=mesh8)(on_mesh)
        HaloExchange(spec)(stacked)
        torch.cuda.synchronize()
        for q in stacked:
            check(torch.equal(join_positions(on_mesh[q], spec), stacked[q]),
                  f"mesh exchange {label} q{q} != resident exchange")
        log(f"mesh exchange {label}: == the resident axis-composed exchange on every cell")
        del stacked, on_mesh

    # 8 steps at 512^3 from a random field over the mesh against the
    # single-block default path
    spec_m1 = rspec((512,) * 3, (2, 2, 2), 1)
    gen.manual_seed(430)
    g8 = torch.rand((512, 512, 512), generator=gen, device=dev)
    sel_g = sel_block(spec512)[(0, 0, 0, *[slice(o, o + 512) for o in
                                           (off1.z, off1.y, off1.x)])].contiguous()
    ref8, _ = make_jacobi_loop(HaloExchange(spec512), 8)(
        place(g8, spec512), torch.zeros(spec512.stacked_shape_zyx(), device=dev),
        place(sel_g, spec512))
    ref8 = gather(ref8, spec512)
    del sel_g
    ex9 = HaloExchange(spec_m1, Method.REMOTE_DMA, mesh=mesh8)
    c9 = split_positions(place(g8, spec_m1), spec_m1, mesh8)
    out9, _ = make_jacobi_loop(ex9, 8)(c9, [torch.zeros_like(b) for b in c9],
                                       sphere_sel_blocks(spec_m1, mesh8))
    torch.cuda.synchronize()
    plain8 = gather(join_positions(out9, spec_m1), spec_m1)  # phase 10 holds its loops to both
    check(torch.equal(plain8, ref8),
          "jacobi 512^3 8 steps over 8 positions != the single-block default path")
    log("jacobi 512^3 8 steps over 8 positions (remote_axis + sweeps): == the single-block "
        "default path")
    del c9, out9, ex9

    # the main path: jacobi3d at 512^3 over 8 positions of one card
    # (one sweep_positions launch a step covers the 8 positions)
    counted9 = {"remote_axis": rdma.remote_axis, "jacobi_sweep": sk.sweep,
                "jacobi_sweep_positions": sk.sweep_positions, "self_fill": halo_fill.self_fill,
                "jacobi_multistep": sk.multistep, "fused_exchange": fst.fused_exchange}
    for fn in counted9.values():
        fn.launches = 0
    rv = jacobi3d.run(512, 512, 512, devices=[dev] * 8, method=Method.REMOTE_DMA, iters=50,
                      chunk=25, weak=False)
    torch.cuda.synchronize()
    got9 = {name: fn.launches for name, fn in counted9.items()}
    want9 = {"remote_axis": 75 * 3, "jacobi_sweep": 0, "jacobi_sweep_positions": 75, "self_fill": 0,
             "jacobi_multistep": 0, "fused_exchange": 0}
    check(got9 == want9, f"jacobi3d over 8 positions: launches {got9}, expected {want9}")
    launches["remote_axis"] = got9["remote_axis"]
    launches["jacobi_sweep_positions"] = got9["jacobi_sweep_positions"]
    fin = gather(join_positions(rv["domain"].get_curr(rv["handle"]), rv["domain"].spec),
                 rv["domain"].spec)
    check(bool(torch.isfinite(fin).all()) and float(fin.min()) >= 0.0
          and float(fin.max()) <= 1.0 and bool((fin[hot_d] == 1.0).all())
          and bool((fin[cold_d] == 0.0).all()),
          "jacobi3d over 8 positions: field not finite, out of range or spheres lost")
    log(jacobi3d.csv_row(rv))
    log(f"jacobi3d 512^3 over 8 positions of one card (remote-dma): "
        f"{rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), {rv['mcells_per_s']:.1f} "
        f"Mcells/s, launches {got9}")
    del rv, fin

    # the main path's sweep of the 8 positions (256^3 blocks, no wrap) in one
    # launch, each position's spheres on its own planes, and with random sel
    # codes on every plane; and one position alone
    bspec = spec_m1.block_spec()
    c9 = [rand_block(bspec, 460 + i) for i in range(8)]
    n9 = [torch.zeros_like(b) for b in c9]
    sph9 = sphere_sel_blocks(spec_m1, mesh8)
    rnd9 = [rand_sel(bspec, 470 + i, -1, 4) for i in range(8)]
    rg9 = [sk.block_sel_range(spec_m1, Dim3.of(pos).z) for pos in mesh8.positions()]
    errs["jacobi_sweep_positions"] = 0.0
    for what, s9, rg in (("spheres on their planes", sph9, rg9), ("random sel", rnd9, None)):
        got = sk.sweep_positions(c9, [b.clone() for b in n9], s9, bspec, rg)
        want = [sk.sweep_plain(c, n.clone(), s, bspec, fst.NO_WRAP, r)
                for c, n, s, r in zip(c9, n9, s9, rg or [None] * 8)]
        torch.cuda.synchronize()
        errs["jacobi_sweep_positions"] = max(errs["jacobi_sweep_positions"],
                                        *(max_abs(a, b) for a, b in zip(got, want)))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"sweep of 8 positions of 256^3, {what}: kernel != plain")
    log("sweep_positions over 8 positions of 256^3: equal with the spheres on their planes "
        "and random sel")
    whole9 = [Rect3(bspec.compute_offset(), bspec.compute_offset() + bspec.base)]
    timings["jacobi_sweep_positions"] = b1_form(
        lambda: sk.sweep_positions(c9, n9, sph9, bspec, rg9),
        lambda: [sk.sweep_plain(c, n, s, bspec, fst.NO_WRAP, r)
                 for c, n, s, r in zip(c9, n9, sph9, rg9)], bspec, whole9 * 8, None,
        plain_reps=1)
    full9, ranged9 = 0, 0
    for r in rg9:
        f, g = sk.sweep_bytes(bspec, whole9, r)
        full9, ranged9 = full9 + f, ranged9 + g
    timings["jacobi_sweep_positions"]["bound"] = bound_ms(ranged9, full9 // 2)
    b1_log("jacobi_sweep_positions", timings["jacobi_sweep_positions"],
           "8 positions of 256^3 in one launch, each position's spheres on its planes")
    one9 = b1_form(lambda: sk.sweep(c9[0], n9[0], sph9[0], bspec, fst.NO_WRAP, rg9[0]),
                   lambda: sk.sweep_plain(c9[0], n9[0], sph9[0], bspec, fst.NO_WRAP, rg9[0]),
                   bspec, whole9, rg9[0], reps=40, plain_reps=1)
    b1_log("jacobi_sweep_positions", one9, "one position of 256^3 alone (z block 0)")
    timings["jacobi_sweep_positions"]["extra"]["one_position_ms"] = one9["ms"]
    del c9, n9, sph9, rnd9, got, want, one9

    # DistributedDomain.exchange_loop at config 2 through B6 and through B7
    c2 = resident_gbs["config 2: 256^3 (2,2,2) r2 x4"]
    sector_ms = {}  # each carrier's sector floor, for the log only
    for fused in (False, True):
        name = "fused_exchange" if fused else "remote_axis"
        dd = DistributedDomain(256, 256, 256)
        dd.set_radius(2)
        dd.set_methods(Method.REMOTE_DMA)
        dd.set_devices([dev] * 8)
        dd.set_fused_exchange(fused)
        hs = [dd.add_data(f"q{i}", "float32") for i in range(4)]
        dd.realize()
        st9 = rand_mesh(dd.spec, [f32] * 4, 440)
        for i, hq in enumerate(hs):
            dd.set_curr(hq, st9[i])
        for fn in counted9.values():
            fn.launches = 0
        dd.exchange_loop(1)(dd.curr_state())
        torch.cuda.synchronize()
        got = {n_: fn.launches for n_, fn in counted9.items() if fn.launches}
        check(got == {name: 1 if fused else 3},
              f"config-2 exchange over 8 positions ({name}): launches {got}")
        if fused:
            launches["fused_exchange"] = got[name]
        loop10 = dd.exchange_loop(10)
        ex_ms = time_ms(lambda: loop10(dd.curr_state()), 3, warmup=1) / 10
        nbytes = dd.exchange_bytes_for_method(Method.REMOTE_DMA)
        plan9 = dd.halo_exchange.plan
        groups = grouped(dd.curr_state(), list(range(4)))
        ring = [ph for ph in plan9.remote_phases if ph.active]
        if fused:
            kern_ms = time_ms(lambda: fst.fused_exchange(groups, dd.spec, plan9, mesh8), 20,
                              graph=True)
            plain_ms = time_ms(lambda: fst.fused_exchange_plain(groups, dd.spec, plan9, mesh8), 3)
            lib_ms = time_ms(lambda: copy_boxes(dd.curr_state(), mesh8, plan9), 5, graph=True)
            kbytes = fst.fused_exchange_bytes(plan9, 4, 8, 4)
            sbytes = fst.fused_exchange_sector_bytes(plan9, dd.spec, 4, 8, 4)
        else:
            def phases(fn):
                for ph in ring:
                    fn(groups, dd.spec, ph, mesh8)
            # each phase alone, then the host's share of the exchange: its
            # time through exchange_loop against its three launches' device time
            per_phase = [time_ms(lambda ph=ph: rdma.remote_axis(groups, dd.spec, ph, mesh8), 20,
                                 graph=True) for ph in ring]
            kern_ms = sum(per_phase) / len(ring)
            plain_ms = time_ms(lambda: phases(rdma.remote_axis_plain), 3) / len(ring)
            lib_ms = time_ms(lambda: copy_slabs(dd.curr_state(), dd.spec, mesh8, ring), 5,
                             graph=True) / len(ring)
            kbytes = sum(rdma.remote_axis_bytes(dd.spec, ph, 4, 8, 4) for ph in ring) / len(ring)
            sbytes = sum(rdma.remote_axis_sector_bytes(dd.spec, ph, 4, 8, 4)
                         for ph in ring) / len(ring)
            for ph, ms_ph in zip(ring, per_phase):
                log(f"time remote_axis config 2 {ph.axis}: {ms_ph:.4f} ms per launch (bound "
                    f"{bound_ms(rdma.remote_axis_bytes(dd.spec, ph, 4, 8, 4), 0)[0]:.4f} ms by "
                    f"bytes, sector floor "
                    f"{bound_ms(rdma.remote_axis_sector_bytes(dd.spec, ph, 4, 8, 4), 0)[0]:.4f} ms)")
            log(f"mesh exchange config 2 via remote_axis: {ex_ms:.4f} ms an exchange through "
                f"exchange_loop, {sum(per_phase):.4f} ms of it its three launches' device time, "
                f"{ex_ms - sum(per_phase):.4f} ms beyond them (host)")
        timings[name] = dict(ms=kern_ms, plain_ms=plain_ms, bound=bound_ms(kbytes, 0),
                             library_ms=lib_ms)
        sector_ms[name] = bound_ms(sbytes, 0)[0]
        per_ex = lib_ms * (1 if fused else len(ring))
        log(f"mesh exchange config 2 over 8 positions via {name}: {ex_ms:.4f} ms, "
            f"{nbytes / ex_ms / 1e6:.2f} GB/s logical ({nbytes} bytes); resident config 2 in "
            f"this run {c2:.2f} GB/s; Tensor.copy_ of the same slabs {per_ex:.4f} ms = "
            f"{nbytes / per_ex / 1e6:.2f} GB/s")
        del dd, st9, groups, loop10
    # B6 per launch at the jacobi path's own shape (512^3 (2,2,2) r1 x1), and
    # B7 at the same shape
    st9 = rand_mesh(spec_m1, [f32], 450)
    groups = grouped(st9, [0])
    ring = [ph for ph in build_plan(spec_m1, (2, 2, 2), Method.REMOTE_DMA).remote_phases]
    for ph in ring:
        ms9 = time_ms(lambda: rdma.remote_axis(groups, spec_m1, ph, mesh8), 20, graph=True)
        b9 = bound_ms(rdma.remote_axis_bytes(spec_m1, ph, 1, 8, 4), 0)[0]
        f9 = bound_ms(rdma.remote_axis_sector_bytes(spec_m1, ph, 1, 8, 4), 0)[0]
        log(f"time remote_axis 512^3 (2,2,2) r1 x1 {ph.axis}: {ms9:.4f} ms per launch "
            f"(bound {b9:.4f} ms by bytes, sector floor {f9:.4f} ms)")
    fplan1 = build_plan(spec_m1, (2, 2, 2), Method.REMOTE_DMA, fused=True)
    ms9 = time_ms(lambda: fst.fused_exchange(groups, spec_m1, fplan1, mesh8), 20, graph=True)
    log(f"time fused_exchange 512^3 (2,2,2) r1 x1: {ms9:.4f} ms per launch (bound "
        f"{bound_ms(fst.fused_exchange_bytes(fplan1, 1, 8, 4), 0)[0]:.4f} ms by bytes, sector "
        f"floor {bound_ms(fst.fused_exchange_sector_bytes(fplan1, spec_m1, 1, 8, 4), 0)[0]:.4f} "
        "ms)")
    del st9, groups
    for name in ("remote_axis", "fused_exchange"):
        t = timings[name]
        log(f"time {name} config 2: {t['ms']:.4f} ms per launch (plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound'][0]:.4f} ms by {t['bound'][1]}, sector floor "
            f"{sector_ms[name]:.4f} ms, Tensor.copy_ {t['library_ms']:.4f} ms)")

    # the narrowed wire's forms of B6 and B7, and the plain mesh path with a wire
    t9, l9, e9, wire_refs = mesh_wire_phase(dev, time_ms)
    timings.update(t9)
    launches.update(l9)
    errs.update(e9)
    for name in t9:
        t = t9[name]
        log(f"time {name} config 2, bf16 on the wire: {t['ms']:.4f} ms per launch (unnarrowed "
            f"{t['extra']['ms_unnarrowed']:.4f}, fp8 {t['extra']['ms_fp8']:.4f}; plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by {t['bound'][1]})")

    # every other format the JAX package narrows through, B6 and B7; the
    # wire on an oversubscribed mesh and on the Astaroth mesh
    t9b, l9b, e9b = mesh_formats_phase(dev, time_ms)
    timings.update(t9b)
    launches.update(l9b)
    errs.update(e9b)
    for name, t in t9b.items():
        log(f"time {name} ({t['extra'].get('wire', 'float8_e5m2')}): {t['ms']:.4f} ms per launch "
            f"(unnarrowed {t['extra']['ms_unnarrowed']:.4f}; plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound'][0]:.4f} ms by {t['bound'][1]}); {l9b[name]} launches on its main path")

    # -- 10. mesh variants: the fused step and the persistent chunk over 8 ---
    #        block positions, one cooperative launch for every position
    for key in ("fused_jacobi_mesh", "persistent_jacobi_mesh"):
        errs[key] = 0.0

    def rand_fields(spec, seed, codes=(0, 3)):
        """(currs, nxts, sels) of a mesh of spec: random everywhere."""
        st = rand_mesh(spec, [f32, f32], seed)
        return st[0], st[1], [rand_sel(spec, seed + 2 + i, *codes)
                              for i in range(spec.num_blocks())]

    fused_mesh_cases = [("512^3 (2,2,2) r1", spec_m1, (0, 3)),
                        ("100x70x60 (1,1,2) r1", rspec((100, 70, 60), (1, 1, 2), 1), (0, 3)),
                        ("24x20x16 (2,1,1) r1 sel in [-1, 4)",
                         rspec((24, 20, 16), (2, 1, 1), 1), (-1, 4))]
    for i, (label, spec, codes) in enumerate(fused_mesh_cases):
        mesh = mesh_of(spec)
        plan = build_plan(spec, spec.dim, Method.REMOTE_DMA, fused=True)
        c, n, s = rand_fields(spec, 500 + 10 * i, codes)
        pc, pn = cloned([c])[0], cloned([n])[0]
        fst.fused_jacobi_mesh(c, n, s, spec, plan, mesh)
        fst.fused_jacobi_mesh_plain(pc, pn, s, spec, plan, mesh)
        torch.cuda.synchronize()
        errs["fused_jacobi_mesh"] = max(errs["fused_jacobi_mesh"], err_of([c, n], [pc, pn]))
        check(same([c, n], [pc, pn]), f"fused_jacobi_mesh {label}: kernel != plain")
        log(f"fused_jacobi_mesh {label}: equal (every position's curr with halos, and nxt)")
        del c, n, s, pc, pn

    pers_mesh_cases = [(f"200x100x60 (2,2,2) k={k}", rspec((200, 100, 60), (2, 2, 2), k), k,
                        (0, 3)) for k in (2, 3, 4)]
    pers_mesh_cases += [("200x100x60 (2,2,2) k=8 sel in [-1, 4)",
                         rspec((200, 100, 60), (2, 2, 2), 8), 8, (-1, 4)),
                        ("66x42x26 (2,2,2) k=3 sel in [-1, 4)",
                         rspec((66, 42, 26), (2, 2, 2), 3), 3, (-1, 4)),
                        ("16x16x14 (2,1,1) k=2", rspec((16, 16, 14), (2, 1, 1), 2), 2, (0, 3)),
                        ("512^3 (2,2,2) k=4", rspec((512,) * 3, (2, 2, 2), 4), 4, (0, 3))]
    for i, (label, spec, k, codes) in enumerate(pers_mesh_cases):
        mesh = mesh_of(spec)
        c, n, s = rand_fields(spec, 520 + 10 * i, codes)
        pc, pn, ps = cloned([c])[0], cloned([n])[0], cloned([s])[0]
        pst.persistent_jacobi_mesh(c, n, s, spec, k, mesh)
        pst.persistent_jacobi_mesh_plain(pc, pn, ps, spec, k, mesh)
        torch.cuda.synchronize()
        errs["persistent_jacobi_mesh"] = max(errs["persistent_jacobi_mesh"],
                                             err_of([c, n], [pc, pn]))
        check(same([c, n, s], [pc, pn, ps]), f"persistent_jacobi_mesh {label}: kernel != plain")
        log(f"persistent_jacobi_mesh {label}: equal (both buffers of every position, halos "
            "included)")
        del c, n, s, pc, pn, ps

    # 8 steps at 512^3 over 8 positions from phase 9's random field: the
    # fused loop and the persistent loop (k=4, radius-4 layout) against the
    # single-block default path and the plain mesh loop
    spec_m4 = rspec((512,) * 3, (2, 2, 2), 4)
    for label, spec, kw, tk in (("fused", spec_m1, dict(fused=True), None),
                                ("persistent (k=4)", spec_m4, dict(persistent=True), 4)):
        ex10 = HaloExchange(spec, Method.REMOTE_DMA, mesh=mesh8, **kw)
        c10 = split_positions(place(g8, spec), spec, mesh8)
        out10, _ = make_jacobi_loop(ex10, 8, temporal_k=tk)(
            c10, [torch.zeros_like(b) for b in c10], sphere_sel_blocks(spec, mesh8))
        got10 = gather(join_positions(out10, spec), spec)
        torch.cuda.synchronize()
        check(torch.equal(got10, ref8) and torch.equal(got10, plain8),
              f"jacobi 512^3 8 steps over 8 positions, {label} loop != the single-block "
              "default path or the plain mesh loop")
        log(f"jacobi 512^3 8 steps over 8 positions, {label} loop: == the single-block default "
            "path == the plain mesh loop")
        del ex10, c10, out10, got10
    del g8, ref8, plain8

    # the main paths: jacobi3d at 512^3 over 8 positions through each kernel
    counted10 = {**counted9, "fused_jacobi_mesh": fst.fused_jacobi_mesh,
                 "persistent_jacobi_mesh": pst.persistent_jacobi_mesh,
                 "fused_jacobi": fst.fused_jacobi, "persistent_jacobi": pst.persistent_jacobi}
    mesh_runs = [
        ("fused", dict(iters=50, chunk=25, kernel_variant="fused"), {"fused_jacobi_mesh": 75}),
        ("persistent", dict(iters=48, chunk=24, kernel_variant="persistent", deep_halo=4),
         {"persistent_jacobi_mesh": 18, "remote_axis": 9}),
    ]
    for label, kw, want in mesh_runs:
        for fn in counted10.values():
            fn.launches = 0
        rv = jacobi3d.run(512, 512, 512, devices=[dev] * 8, method=Method.REMOTE_DMA,
                          weak=False, **kw)
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counted10.items()}
        check(got == {name: want.get(name, 0) for name in counted10},
              f"jacobi3d {label} over 8 positions: launches {got}, expected {want}")
        name = f"{label}_jacobi_mesh"
        launches[name] = got[name]
        if label == "persistent":
            lpc = rv["domain"].halo_exchange.last_launches_per_chunk
            check(lpc == 1, f"jacobi3d persistent over 8 positions: {lpc} launches per chunk")
        fin = gather(join_positions(rv["domain"].get_curr(rv["handle"]), rv["domain"].spec),
                     rv["domain"].spec)
        check(bool(torch.isfinite(fin).all()) and float(fin.min()) >= 0.0
              and float(fin.max()) <= 1.0 and bool((fin[hot_d] == 1.0).all())
              and bool((fin[cold_d] == 0.0).all()),
              f"jacobi3d {label} over 8 positions: field not finite, out of range or spheres "
              "lost")
        log(jacobi3d.csv_row(rv))
        log(f"jacobi3d 512^3 over 8 positions of one card (remote-dma {label}): "
            f"{rv['iter_trimean_s'] * 1e3:.4f} ms/iter (trimean), {rv['mcells_per_s']:.1f} "
            f"Mcells/s, launches {got}")
        del rv, fin

    # per-launch times at the main paths' shapes; cooperative launches are
    # timed without a CUDA graph (events around back-to-back launches)
    plan10 = build_plan(spec_m1, (2, 2, 2), Method.REMOTE_DMA, fused=True)
    c, n, s = rand_fields(spec_m1, 560)
    timings["fused_jacobi_mesh"] = dict(
        ms=time_ms(lambda: fst.fused_jacobi_mesh(c, n, s, spec_m1, plan10, mesh8), 20),
        plain_ms=time_ms(lambda: fst.fused_jacobi_mesh_plain(c, n, s, spec_m1, plan10, mesh8),
                         3, warmup=1),
        bound=bound_ms(fst.fused_jacobi_mesh_bytes(plan10, 8, spec_m1), 6 * cells),
        library_ms=None)
    del c, n, s
    c, n, s = rand_fields(spec_m4, 570)
    HaloExchange(spec_m4, Method.REMOTE_DMA, mesh=mesh8)(s)
    grown = 8 * sum((256 + 2 * g) ** 3 for g in range(4))
    bspec4 = spec_m4.block_spec()
    timings["persistent_jacobi_mesh"] = dict(
        ms=time_ms(lambda: pst.persistent_jacobi_mesh(c, n, s, spec_m4, 4, mesh8), 10),
        plain_ms=time_ms(lambda: pst.persistent_jacobi_mesh_plain(c, n, s, spec_m4, 4, mesh8),
                         1, warmup=1),
        bound=bound_ms(8 * pst.chunk_bytes(bspec4, 4), 6 * grown), library_ms=None)
    del c, n, s
    design10 = bound_ms(8 * pst.chunk_design_bytes(bspec4, 4), 6 * grown)[0]
    for name in ("fused_jacobi_mesh", "persistent_jacobi_mesh"):
        t = timings[name]
        log(f"time {name} 512^3 over 8 positions: {t['ms']:.4f} ms per launch (plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by {t['bound'][1]})")
    log(f"persistent_jacobi_mesh k=4: {timings['persistent_jacobi_mesh']['ms'] / 4:.4f} ms per "
        f"step; the design's own traffic bounds it at {design10:.4f} ms")

    # the narrowed wire's form of B8, and the fused mesh path with a wire
    t10, l10, e10 = variant_wire_phase(dev, time_ms, wire_refs)
    del wire_refs
    timings.update(t10)
    launches.update(l10)
    errs.update(e10)
    t = t10["fused_jacobi_mesh_wire"]
    log(f"time fused_jacobi_mesh 512^3 over 8 positions, bf16 on the wire: {t['ms']:.4f} ms per "
        f"launch (unnarrowed {t['extra']['ms_unnarrowed']:.4f}, fp8 {t['extra']['ms_fp8']:.4f}; "
        f"plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by {t['bound'][1]})")

    # B8 through every other format
    t10b, l10b, e10b = variant_formats_phase(dev, time_ms)
    timings.update(t10b)
    launches.update(l10b)
    errs.update(e10b)
    for name, t in t10b.items():
        log(f"time {name} ({t['extra']['wire']}): {t['ms']:.4f} ms per launch (unnarrowed "
            f"{t['extra']['ms_unnarrowed']:.4f}; plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound'][0]:.4f} ms by {t['bound'][1]}); {l10b[name]} launches on its main path")

    # -- 11. the guarded main path: health kernel, headline leg, rollbacks ----
    from stencil_tpu_torch.ops import health_reduce as hr

    timings["health_reduce"], launches["health_reduce"], errs["health_reduce"] = \
        guarded_phase(dev, time_ms)
    t = timings["health_reduce"]
    log(f"time health_reduce 512^3 fp32: {t['ms']:.4f} ms per launch (torch passes "
        f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms); B=64 of 128^3 per lane "
        f"{t['extra']['lanes_ms']:.4f} ms (torch passes {t['extra']['lanes_plain_ms']:.4f} ms, "
        f"bound {t['extra']['lanes_bound_ms']:.4f} ms); {hr.health_reduce.launches} launches "
        "in phase 11")

    # -- 12. uneven partitions: B6's uneven ring, the resident uneven exchange --
    #        and jacobi3d over 6 positions and (3,2,1) residents
    t12, l12, e12 = uneven_phase(dev, time_ms,
                                 c2_gbs=resident_gbs["config 2: 256^3 (2,2,2) r2 x4"])
    timings.update(t12)
    launches.update(l12)
    errs.update(e12)
    t = t12["remote_axis_uneven"]
    log(f"time remote_axis uneven 512^3 (3,2,1) r1: {t['ms']:.4f} ms per launch, mean of its "
        f"ring phases (plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms by "
        f"{t['bound'][1]}, Tensor.copy_ {t['library_ms']:.4f} ms); "
        f"{l12['remote_axis_uneven']} launches on the 6-position main path")

    # -- 13. float64: the fp64 forms of B1 and B2/B3 and the fp64 main paths ---
    t13, l13, e13 = fp64_phase(dev, time_ms)
    timings.update(t13)
    launches.update(l13)
    errs.update(e13)

    # -- 14. astaroth over resident blocks: B5's table form and the app ----------
    t14, l14, e14 = astaroth_resident_phase(dev, time_ms)
    timings.update(t14)
    launches.update(l14)
    errs.update(e14)

    # -- 15. the rest of the one-card surface: DIRECT26, REMOTE_DMA on residents, ---
    #        multistep rows, B9's uneven chunk
    t15, l15, e15 = surface_phase(dev, time_ms)
    timings.update(t15)
    launches.update(l15)
    errs.update(e15)

    # -- 16. the serving path: B5's and B4's tenant forms, the Astaroth campaign, ---
    #        the serving daemon
    t16, l16, e16 = tenants_phase(dev, time_ms)
    timings.update(t16)
    launches.update(l16)
    errs.update(e16)

    # -- 17. astaroth over a mesh of block positions: B5's positions form, the ---
    #        step, the fused loop and the app over 8 positions
    t17, l17, e17 = astaroth_mesh_phase(dev, time_ms)
    timings.update(t17)
    launches.update(l17)
    errs.update(e17)

    # -- 18. the exchange planner: autotune on one device and over 8 positions, ---
    #        the DB replay, the hot-swap, the card's calibration row, astaroth
    l18, plan_report = plan_phase(dev)
    for name, v in l18.items():
        timings[name].setdefault("extra", {})["plan_phase_launches"] = v
    log(f"plan phase report: {json.dumps(plan_report, sort_keys=True, default=str)}")

    # -- 19. the measurement tools: the profiler capture, the record tools, the ---
    #        bench apps
    tools_report, profiler_ms = tools_phase(dev)
    for name, v in profiler_ms.items():
        timings[name].setdefault("extra", {})["profiler_ms"] = v
    log(f"tools phase report: {json.dumps(tools_report, sort_keys=True, default=str)}")

    # -- report ---------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
        else f"nvidia-smi unavailable (rc {smi.returncode})")
    meta = {
        "jacobi_sweep": ("stencil_tpu_torch/csrc/jacobi_sweep.cu",
                         "stencil_tpu/ops/pallas_stencil.py:119"),
        "jacobi_multistep": ("stencil_tpu_torch/csrc/jacobi_multistep.cu",
                             "stencil_tpu/ops/pallas_stencil.py:437"),
        "self_fill": ("stencil_tpu_torch/csrc/self_fill.cu", "stencil_tpu/ops/halo_fill.py:236"),
        "astaroth_substep": ("stencil_tpu_torch/csrc/astaroth_substep.cu",
                             "stencil_tpu/ops/pallas_astaroth.py:202"),
        "fused_jacobi": ("stencil_tpu_torch/csrc/fused_jacobi.cu",
                         "stencil_tpu/ops/fused_stencil.py:250"),
        "persistent_jacobi": ("stencil_tpu_torch/csrc/persistent_jacobi.cu",
                              "stencil_tpu/ops/persistent_stencil.py:199"),
        # the deep-halo forms (full-plane :709 and row-tiled :993) of
        # make_pallas_jacobi_multistep, the sweep on the overlap shells, and
        # the z-stack fill
        "jacobi_multistep_deep_halo": ("stencil_tpu_torch/csrc/jacobi_multistep.cu",
                                       "stencil_tpu/ops/pallas_stencil.py:709"),
        "jacobi_sweep_regions": ("stencil_tpu_torch/csrc/jacobi_sweep.cu",
                                "stencil_tpu/ops/pallas_stencil.py:119"),
        "self_fill_z_stack": ("stencil_tpu_torch/csrc/self_fill.cu",
                              "stencil_tpu/ops/halo_fill.py:236"),
        # the batch= form (a leading tenant axis on the grid, every axis wrapping)
        "jacobi_sweep_batched": ("stencil_tpu_torch/csrc/jacobi_sweep.cu",
                                 "stencil_tpu/ops/pallas_stencil.py:119"),
        # the mesh kernels: the axis carrier and the fused exchange carrier
        "remote_axis": ("stencil_tpu_torch/csrc/remote_axis.cu",
                        "stencil_tpu/ops/remote_dma.py:68"),
        "fused_exchange": ("stencil_tpu_torch/csrc/fused_exchange.cu",
                           "stencil_tpu/ops/fused_stencil.py:100"),
        # the sweep of every mesh position (no wrap), one launch a step
        "jacobi_sweep_positions": ("stencil_tpu_torch/csrc/jacobi_sweep.cu",
                              "stencil_tpu/ops/pallas_stencil.py:119"),
        # the wire-crossing forms of the fused step and the persistent chunk
        "fused_jacobi_mesh": ("stencil_tpu_torch/csrc/fused_jacobi.cu",
                              "stencil_tpu/ops/fused_stencil.py:250"),
        "persistent_jacobi_mesh": ("stencil_tpu_torch/csrc/persistent_jacobi.cu",
                                   "stencil_tpu/ops/persistent_stencil.py:199"),
        # the wire_dtype forms: each crossing word rounded through the wire
        # (csrc/wire_round.cuh) between its load and its store
        "remote_axis_wire": ("stencil_tpu_torch/csrc/remote_axis.cu",
                             "stencil_tpu/ops/remote_dma.py:101"),
        "fused_exchange_wire": ("stencil_tpu_torch/csrc/fused_exchange.cu",
                                "stencil_tpu/ops/fused_stencil.py:118"),
        "fused_jacobi_mesh_wire": ("stencil_tpu_torch/csrc/fused_jacobi.cu",
                                   "stencil_tpu/ops/fused_stencil.py:292"),
        # the same through fp8 e5m2 (the card's conversion) and through a
        # format the card does not convert (the SOFT instantiation); B6's
        # over the blocks of an oversubscribed mesh (only the slabs between
        # positions round)
        "remote_axis_wire_e5m2": ("stencil_tpu_torch/csrc/remote_axis.cu",
                                  "stencil_tpu/ops/remote_dma.py:101"),
        "remote_axis_wire_soft": ("stencil_tpu_torch/csrc/remote_axis.cu",
                                  "stencil_tpu/ops/remote_dma.py:101"),
        "fused_exchange_wire_e5m2": ("stencil_tpu_torch/csrc/fused_exchange.cu",
                                     "stencil_tpu/ops/fused_stencil.py:118"),
        "fused_exchange_wire_soft": ("stencil_tpu_torch/csrc/fused_exchange.cu",
                                     "stencil_tpu/ops/fused_stencil.py:118"),
        "fused_jacobi_mesh_wire_e5m2": ("stencil_tpu_torch/csrc/fused_jacobi.cu",
                                        "stencil_tpu/ops/fused_stencil.py:292"),
        "fused_jacobi_mesh_wire_soft": ("stencil_tpu_torch/csrc/fused_jacobi.cu",
                                        "stencil_tpu/ops/fused_stencil.py:292"),
        "remote_axis_wire_oversubscribed": ("stencil_tpu_torch/csrc/remote_axis.cu",
                                            "stencil_tpu/ops/remote_dma.py:101"),
        # no Pallas builder: the JAX guard's fused XLA reduction
        "health_reduce": ("stencil_tpu_torch/csrc/health_reduce.cu",
                          "stencil_tpu/fault/health.py:84"),
        # the uneven ring: each block's hi side at its own size (sz_my)
        "remote_axis_uneven": ("stencil_tpu_torch/csrc/remote_axis.cu",
                               "stencil_tpu/ops/remote_dma.py:118"),
        # B1 over the 6 uneven positions, and over their 36 shells, one
        # launch each a step (the uneven plain and fused steps)
        "jacobi_sweep_positions_uneven": ("stencil_tpu_torch/csrc/jacobi_sweep.cu",
                                "stencil_tpu/ops/pallas_stencil.py:119"),
        "jacobi_sweep_regions_uneven": ("stencil_tpu_torch/csrc/jacobi_sweep.cu",
                                       "stencil_tpu/ops/pallas_stencil.py:119"),
        # B5's table form over every resident block (the JAX package runs
        # the Pallas substep once per resident), and over their exterior
        # shells (its overlap iteration re-integrates them after the exchange)
        "astaroth_substep_resident": ("stencil_tpu_torch/csrc/astaroth_substep.cu",
                                      "stencil_tpu/ops/pallas_astaroth.py:202"),
        "astaroth_substep_shells": ("stencil_tpu_torch/csrc/astaroth_substep.cu",
                                    "stencil_tpu/ops/pallas_astaroth.py:202"),
        # B6 with every resident block an endpoint (REMOTE_DMA on residents,
        # and 8 blocks on 4 positions); B1 over the stack on the direct26
        # step; B9's uneven form (no messages, each position at its extent)
        "remote_axis_resident": ("stencil_tpu_torch/csrc/remote_axis.cu",
                                 "stencil_tpu/ops/remote_dma.py:68"),
        "jacobi_sweep_direct26": ("stencil_tpu_torch/csrc/jacobi_sweep.cu",
                                  "stencil_tpu/ops/pallas_stencil.py:119"),
        "persistent_jacobi_mesh_uneven": ("stencil_tpu_torch/csrc/persistent_jacobi.cu",
                                          "stencil_tpu/ops/persistent_stencil.py:199"),
        # B5 over a campaign slot's tenant stack (one task a tenant; the JAX
        # package steps Astaroth tenants on XLA), and B4 over the same stack
        # (z wrapping each tenant onto itself)
        "astaroth_substep_tenants": ("stencil_tpu_torch/csrc/astaroth_substep.cu",
                                     "stencil_tpu/ops/pallas_astaroth.py:202"),
        "self_fill_tenants": ("stencil_tpu_torch/csrc/self_fill.cu",
                              "stencil_tpu/ops/halo_fill.py:236"),
        # B5's positions form: every position of a mesh in one launch (the
        # JAX package runs the Pallas substep inside shard_map on every
        # device), and every position's shells
        "astaroth_substep_positions": ("stencil_tpu_torch/csrc/astaroth_substep.cu",
                                       "stencil_tpu/ops/pallas_astaroth.py:202"),
        "astaroth_substep_positions_shells": ("stencil_tpu_torch/csrc/astaroth_substep.cu",
                                              "stencil_tpu/ops/pallas_astaroth.py:202"),
    }
    # the float64 forms: the same sources and TPU builders (whose Pallas
    # kernels are float32 only; the JAX package steps float64 on XLA)
    meta.update({name: meta[base] for name, base in FP64_FORMS.items()})
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"], **t.get("extra", {}),
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
